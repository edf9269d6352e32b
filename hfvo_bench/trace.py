"""Reading a torch.profiler run: device intervals, busy time, kernel time
by name, and the breakdown of device ops and idle gaps. `device_spans` and
`busy_ms` are frozen copies of chip_smoke.py::_device_spans and ::_busy_ms
at commit ccf1f66 (the raw kineto events, since building the profiler's
per-event objects for ~100,000 events takes seconds)."""
from __future__ import annotations

from collections import defaultdict

import torch


def _raw(prof):
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kineto is not None and hasattr(kineto, "events"):
        return list(kineto.events())
    return None


def device_events(prof):
    """[(start_us, end_us, name, correlation id)] of every device event
    (kernels, copies, fills)."""
    raw = _raw(prof)
    if raw is not None:
        out = []
        for e in raw:
            if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
                s = e.start_ns() / 1e3
                out.append((s, s + e.duration_ns() / 1e3, e.name(), e.correlation_id()))
        return out
    return [(e.time_range.start, e.time_range.end, e.name, getattr(e, "id", 0)) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def device_spans(events):
    return [(s, e) for s, e, _, _ in events]


def busy_ms(spans) -> float:
    """Length of the union of the device intervals (microseconds), ms."""
    spans = sorted(spans)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def kernel_time(events, name: str):
    """(launches, device seconds) of the kernels whose name holds `name`."""
    n, t = 0, 0.0
    for s, e, nm, _ in events:
        if name in nm:
            n += 1
            t += (e - s) / 1e6
    return n, t


def top_ops(events, k: int = 10):
    """The k device ops by total time: [[name, seconds]]."""
    acc = defaultdict(float)
    for s, e, nm, _ in events:
        acc[nm[:120]] += (e - s) / 1e6
    return [[n, t] for n, t in sorted(acc.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(events, k: int = 10):
    """The k longest gaps between device intervals, each named by the
    device ops on either side (naming them by the host's stage needs the
    program's own spans): [[name, seconds]]."""
    spans = sorted(events)
    gaps, cur_e, prev = [], None, ""
    for s, e, nm, _ in spans:
        if cur_e is not None and s > cur_e:
            gaps.append((s - cur_e, prev, nm))
        if cur_e is None or e >= cur_e:
            prev = nm
        cur_e = e if cur_e is None else max(cur_e, e)
    gaps.sort(key=lambda g: -g[0])
    return [[f"after {a[:60]} / before {b[:60]}", d / 1e6] for d, a, b in gaps[:k]]
