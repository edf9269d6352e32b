"""Share of the traced slice's wall time in which no device operation ran:
1 - (union of device intervals) / slice seconds, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
