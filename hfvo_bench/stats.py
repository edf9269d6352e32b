"""Order statistics of the benchmark, on all samples of a window."""
from __future__ import annotations

import math


def percentile(values, q: float):
    """The q-th percentile of all values, linearly interpolated between the
    two nearest ranks (numpy's default); None for no values."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
