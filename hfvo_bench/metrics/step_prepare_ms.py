"""Mean host ms of a sequence's step preparation (the program's
`step.prepare` span: the map snapshot when it changed, the uploads of the
prediction and the step's other inputs) a sequence-step, over the calls
after the traced slice."""
from hfvo_bench import spans


def read(ctx):
    v = spans.after_slice(ctx, "step.prepare")
    return 1e3 * v[0] / v[1] if v and v[1] else None
