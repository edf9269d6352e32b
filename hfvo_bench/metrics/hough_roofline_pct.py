"""Hough vote (K3 / K3b) share of its roofline in the traced slice: the
mean bound of its launches from their shapes and voting pixels
(hfvo_bench/roofline.py) over their mean device time by kernel name, %."""
from hfvo_bench import roofline, trace


def read(ctx):
    t = ctx.trace
    if t is None or not t["hough_launches"]:
        return None
    n, dev_s = trace.kernel_time(t["events"], roofline.HOUGH_KERNEL)
    if not n or n != len(t["hough_launches"]):
        return None
    bound_ms = sum(roofline.bound(*roofline.hough_launch(shape, nv))[0] for shape, nv in t["hough_launches"])
    return 100.0 * (bound_ms / 1e3) / dev_s
