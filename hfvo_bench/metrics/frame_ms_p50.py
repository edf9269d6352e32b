"""Median frame latency (ms) over the frames of the window handed in after
the traced slice (the facade layer's steady figure beside p90)."""
from hfvo_bench.stats import percentile


def read(ctx):
    lat = ctx.host["latencies_ms"]
    return percentile(lat, 50) if lat else None
