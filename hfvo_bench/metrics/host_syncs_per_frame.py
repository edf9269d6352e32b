"""Blocking waits of the host on the device (the program's `host_sync`
counter) inside its calls (`facade.track` spans) in the traced slice, over
the frames handed in during it."""
from hfvo_bench import spans


def read(ctx):
    rec = spans.slice_recording(ctx)
    if rec is None or not ctx.trace["frames"]:
        return None
    calls = spans.facade_calls(rec)
    if not calls:
        return None
    n = sum(c.n for c in rec.counts if c.name == "host_sync" and c.call in calls)
    return n / ctx.trace["frames"]
