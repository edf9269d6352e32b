"""90th percentile frame latency (ms, host clock) over the frames of the
window after the traced slice: `frame_latency_ms_p90` where its spread
between runs is too wide for an end-to-end bound (the host's speed sets
it), read as a per-layer number of the facade."""
from hfvo_bench.stats import percentile


def read(ctx):
    lat = ctx.host["latencies_ms"]
    return percentile(lat, 90) if lat else None
