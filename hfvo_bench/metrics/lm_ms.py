"""Mean host ms of the fused step's pose LM (the program's `step.lm` span,
convergence tests included) a fused step, over the calls after the traced
slice."""
from hfvo_bench import spans


def read(ctx):
    v = spans.after_slice(ctx, "step.lm")
    return 1e3 * v[0] / v[1] if v and v[1] else None
