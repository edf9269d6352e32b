"""Mean host ms a fused step waits for its pulled results (the program's
`step.collect` span less its `step.split` child: the event wait), over the
calls after the traced slice."""
from hfvo_bench import spans


def read(ctx):
    v = spans.after_slice(ctx, "step.collect")
    if not v or not v[1]:
        return None
    split = spans.after_slice(ctx, "step.split")
    return 1e3 * (v[0] - split[0]) / v[1]
