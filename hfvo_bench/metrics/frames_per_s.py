"""Frames whose pose came back in the window, all sequences, over the
window's seconds (from the first timed call to the return of the last,
the end-of-window flush included)."""


def read(ctx):
    return ctx.n_returned / ctx.window_s
