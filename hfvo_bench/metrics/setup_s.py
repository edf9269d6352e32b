"""Process start to the first timed frame: CUDA start, the kernels' build
or load, the renders, the system's construction and its warm-up frames."""


def read(ctx):
    return ctx.setup_s
