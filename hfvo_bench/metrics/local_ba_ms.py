"""Mean host ms of a local BA run (`stage_times["local_ba"]` over the runs
that `mapper.n_ba_runs` counts), summed over the trackers, after the
traced slice; None where no BA ran there."""


def read(ctx):
    n = ctx.host["ba_runs"]
    s, _ = ctx.host["stages"].get("local_ba", (0.0, 0))
    return 1e3 * s / n if n else None
