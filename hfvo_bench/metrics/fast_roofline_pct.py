"""FAST (K1 / K1b) share of its roofline in the traced slice: the mean
bound of its launches from their shapes (hfvo_bench/roofline.py) over
their mean device time by kernel name, in %."""
from hfvo_bench import roofline, trace


def read(ctx):
    t = ctx.trace
    if t is None or not t["fast_launches"]:
        return None
    n, dev_s = trace.kernel_time(t["events"], roofline.FAST_KERNEL)
    if not n or n != len(t["fast_launches"]):
        return None
    bound_ms = sum(roofline.bound(*roofline.fast_launch(s))[0] for s in t["fast_launches"])
    return 100.0 * (bound_ms / 1e3) / dev_s
