"""Device operations (kernels, copies, fills) of the traced slice over the
frames handed in during it."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["frames"]:
        return None
    return len(t["events"]) / t["frames"]
