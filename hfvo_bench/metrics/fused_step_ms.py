"""Mean host ms of the tracker's fused step (`stage_times["fused_step"]`,
ending in its sync) over the window after the traced slice."""


def read(ctx):
    s, n = ctx.host["stages"].get("fused_step", (0.0, 0))
    return 1e3 * s / n if n else None
