"""Mean host wait (ms) of the pipelined batch's resolving calls after the
traced slice: `BatchTracker.step_times["resolve"]`, the host waiting on the
device and then running each sequence's host path."""


def read(ctx):
    w = ctx.host["resolve_s"]
    return 1e3 * sum(w) / len(w) if w else None
