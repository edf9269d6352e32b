"""Spans and counters of the host path, on the profiler's clock.

`span(name, stages=None, **ids)` times a block of host work:

    with tracing.span("step.lm"):
        ...

Every span adds its seconds and one call into a process-wide aggregate by
name (`totals()`) and, where it is given one, into a `stages` dict of the
same form (name -> [seconds, count]: a tracker's `stage_times`). That is
all it does while the recorder is off, the default: one `perf_counter_ns`
pair and two dict updates, about a microsecond.

While the recorder is on, each span also keeps a record: its name, start
and end in Unix-epoch nanoseconds (the clock `torch.profiler` stamps its
host and device events with), its own id, its parent's id, the id of the
call it belongs to (the outermost span around it: one call into the system)
and its `ids` (`seq`, the sequence index, and `frame`, the frame id, where
it belongs to one sequence; a span without ids takes its parent's).
`count(name, n)` adds to a counter, attributed to the innermost open span.
The recorder counts `host_sync`, every blocking wait of the host on the
device: the event waits at their sites, and every other wait through
`torch.cuda.set_sync_debug_mode("warn")`, whose warnings it counts, with the
file and line that synchronized, instead of showing them (blocking copies
either way, `.item()`, `bool(tensor)`, `nonzero`, masked indexing,
`torch.linalg.inv`'s check, stream synchronizations; not event waits or
`torch.cuda.synchronize()`). The pose LM counts `lm_kernel`, its one
launch a call on the card, and on its plain path `lm_test`, its convergence
tests (each also a `host_sync`). Records stay in memory until `drain()`.

Recording is on between `enable()` and `disable()`, and, without them, for
every call that starts while a `torch.profiler` session records: a profile
of the program carries its spans. The state is checked when a span opens
with no span open, so a call is recorded whole or not at all. Spans belong
to the thread that drives the system; no span or counter launches a device
operation, waits on the device or allocates device memory.

`innermost_segments`, `idle_by_span` and `ops_by_span` place a device trace
on the spans: device idle time and device operations by the innermost span
open over them.
"""
from __future__ import annotations

import bisect
import time
import warnings
from typing import Dict, List, NamedTuple, Optional

import torch

OUTSIDE = "(outside any span)"
# The warning of torch.cuda.set_sync_debug_mode("warn").
SYNC_WARNING = "called a synchronizing CUDA operation"


class SpanRecord(NamedTuple):
    id: int
    parent: int  # 0 = none
    call: int  # id of the outermost span around this one (its own id if outermost)
    name: str
    start_ns: int  # Unix-epoch nanoseconds
    end_ns: int
    ids: dict  # seq, frame where the span belongs to one sequence


class CountRecord(NamedTuple):
    name: str
    n: int
    span: int  # innermost open span's id, 0 = none
    call: int
    t_ns: int
    site: str = ""  # "file:line" of the Python call that synchronized, where known


class Recording(NamedTuple):
    spans: List[SpanRecord]
    counts: List[CountRecord]


_totals: Dict[str, list] = {}  # name -> [seconds, count], every span of the process
_totals_at_stop: Dict[str, tuple] = {}  # _totals when recording last stopped
_depth = 0  # open spans, recorded or not
_on = False
_explicit = False  # enable() was called: recording does not follow the profiler
_stack: list = []  # open recorded spans, innermost last
_spans: List[SpanRecord] = []
_counts: List[CountRecord] = []
_next_id = 1
_offset_ns = 0  # Unix-epoch ns minus perf_counter ns, read when recording starts
_sync_hook = None  # (catch_warnings, previous sync debug mode) while syncs are counted


class span:
    """Times a block: the process-wide aggregate, `stages` if given, and a
    record while the recorder is on. `seconds` holds its duration after it
    closes."""

    __slots__ = ("name", "stages", "ids", "t0", "id", "parent", "call", "seconds")

    def __init__(self, name: str, stages: Optional[dict] = None, **ids):
        self.name = name
        self.stages = stages
        self.ids = ids
        self.id = 0
        self.seconds = 0.0

    def __enter__(self) -> "span":
        global _depth, _next_id
        if _depth == 0:
            _follow_profiler()
        _depth += 1
        if _on:
            if _sync_hook is None:
                _hook_syncs()
            self.id = _next_id
            _next_id += 1
            if _stack:
                up = _stack[-1]
                self.parent, self.call = up.id, up.call
                if not self.ids:
                    self.ids = up.ids
            else:
                self.parent, self.call = 0, self.id
            _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _depth
        t1 = time.perf_counter_ns()
        _depth -= 1
        dt = (t1 - self.t0) * 1e-9
        self.seconds = dt
        acc = _totals.get(self.name)
        if acc is None:
            acc = _totals[self.name] = [0.0, 0]
        acc[0] += dt
        acc[1] += 1
        if self.stages is not None:
            acc = self.stages.setdefault(self.name, [0.0, 0])
            acc[0] += dt
            acc[1] += 1
        if self.id:
            if _stack and _stack[-1] is self:
                _stack.pop()
            _spans.append(SpanRecord(self.id, self.parent, self.call, self.name,
                                     self.t0 + _offset_ns, t1 + _offset_ns, self.ids))
        return False


class _Nested:
    """A facade inside an open span: only its `stages`, if any, are timed."""

    __slots__ = ("stages", "t0")

    def __init__(self, stages: Optional[dict]):
        self.stages = stages

    def __enter__(self) -> "_Nested":
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.stages is not None:
            acc = self.stages.setdefault("facade.track", [0.0, 0])
            acc[0] += (time.perf_counter_ns() - self.t0) * 1e-9
            acc[1] += 1
        return False


def facade(stages: Optional[dict] = None, **ids):
    """The span of one call into the system, `facade.track`, where no span
    is open; inside one, only `stages` is timed, so that an entry point
    calling another (VOSystem.track_rgbd -> Tracker.track_rgbd) makes one
    span."""
    return span("facade.track", stages, **ids) if _depth == 0 else _Nested(stages)


def count(name: str, n: int = 1, site: str = "") -> None:
    """Add `n` to counter `name` against the innermost open span (only while
    the recorder is on)."""
    if _on:
        up = _stack[-1] if _stack else None
        _counts.append(CountRecord(name, n, up.id if up else 0, up.call if up else 0,
                                   time.perf_counter_ns() + _offset_ns, site))


def enable() -> None:
    """Record from now on, whether or not a profiler runs."""
    global _explicit
    _explicit = True
    _start()


def disable() -> None:
    """Stop recording; from the next call on, recording follows the
    profiler again."""
    global _explicit
    _explicit = False
    _stop()


def enabled() -> bool:
    return _on


def drain() -> Recording:
    """The spans and counts recorded so far, handed over and forgotten."""
    global _spans, _counts
    out = Recording(_spans, _counts)
    _spans, _counts = [], []
    return out


def totals(since_stop: bool = False) -> Dict[str, tuple]:
    """(seconds, count) of every span name over the process; with
    `since_stop`, only what closed after recording last stopped."""
    if not since_stop:
        return {k: (s, n) for k, (s, n) in _totals.items()}
    return {k: (s - _totals_at_stop.get(k, (0.0, 0))[0], n - _totals_at_stop.get(k, (0.0, 0))[1])
            for k, (s, n) in _totals.items()}


def _follow_profiler() -> None:
    if _explicit:
        return
    on = torch.autograd._profiler_enabled()
    if on and not _on:
        _start()
    elif _on and not on:
        _stop()


def _start() -> None:
    global _on, _offset_ns
    if _on:
        return
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = True
    _hook_syncs()


def _stop() -> None:
    global _on, _totals_at_stop, _sync_hook
    if not _on:
        return
    _on = False
    _totals_at_stop = totals()
    if _sync_hook is not None:
        cw, mode = _sync_hook
        _sync_hook = None
        torch.cuda.set_sync_debug_mode(mode)
        cw.__exit__(None, None, None)


def _hook_syncs() -> None:
    """Count the CUDA sync debug mode's warnings as `host_sync` (once CUDA
    is initialized: the recorder never initializes it)."""
    global _sync_hook
    if _sync_hook is not None or not torch.cuda.is_initialized():
        return
    cw = warnings.catch_warnings()
    cw.__enter__()
    warnings.filterwarnings("always", message=SYNC_WARNING)
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            count("host_sync", site=f"{filename}:{lineno}")
        else:
            shown(message, category, filename, lineno, file, line)

    warnings.showwarning = show
    _sync_hook = (cw, torch.cuda.get_sync_debug_mode())
    torch.cuda.set_sync_debug_mode("warn")


# ---- placing a device trace on the spans ----------------------------------


def innermost_segments(spans, lo: float, hi: float) -> list:
    """[(start, end, name)] covering [lo, hi] in order, each piece named by
    the innermost span open over it, or OUTSIDE. `spans`: (start, end, name)
    of properly nested intervals (one thread's spans)."""
    segs: list = []
    stack: list = []
    cur = lo

    def advance(t):
        nonlocal cur
        t = min(max(t, lo), hi)
        if t > cur:
            segs.append((cur, t, stack[-1][2] if stack else OUTSIDE))
            cur = t

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            advance(stack[-1][1])
            stack.pop()
        advance(s)
        stack.append((s, e, name))
    while stack:
        advance(stack[-1][1])
        stack.pop()
    advance(hi)
    return segs


def idle_intervals(device, lo: float, hi: float) -> list:
    """[(start, end)] of [lo, hi] in which no device interval runs."""
    out, cur = [], lo
    for s, e in sorted(device):
        if s > cur and cur < hi:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def idle_by_span(device, spans, lo: float, hi: float) -> Dict[str, float]:
    """Device-idle time of [lo, hi] by the innermost span open over it (a
    span's self time: its interval less its children's), in the units of
    the inputs. `device`: (start, end) of device operations; the values sum
    to the idle time of [lo, hi]."""
    segs = innermost_segments(spans, lo, hi)
    out: Dict[str, float] = {}
    j = 0
    for a, b in idle_intervals(device, lo, hi):
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, e, name = segs[k]
            d = min(b, e) - max(a, s)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
            k += 1
    return out


def ops_by_span(ops, spans, lo: float, hi: float) -> Dict[str, list]:
    """Device operations by the span that launched them: `ops` is
    (launch time, device seconds) per operation, the launch time on the
    spans' clock; returns name -> [operations, device seconds]."""
    segs = innermost_segments(spans, lo, hi)
    starts = [s for s, _, _ in segs]
    out: Dict[str, list] = {}
    for t, sec in ops:
        i = bisect.bisect_right(starts, t) - 1
        name = segs[i][2] if 0 <= i < len(segs) and t < segs[i][1] else OUTSIDE
        acc = out.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += sec
    return out


def top(table: dict, k: int = 10) -> list:
    """The k largest entries of a name -> value (or [count, value]) table,
    by value: [[name, value]] or [[name, count, value]]."""
    key = (lambda kv: kv[1][-1]) if table and isinstance(next(iter(table.values())), list) else (lambda kv: kv[1])
    rows = sorted(table.items(), key=key, reverse=True)[:k]
    return [[n, *v] if isinstance(v, list) else [n, v] for n, v in rows]


def chrome_events(rec: Recording, base_ns: int, pid: int = 0, tid: int = 0) -> list:
    """The records as Chrome trace events (complete events, microseconds
    from `base_ns`, the `baseTimeNanoseconds` of torch.profiler's export)."""
    out = [dict(ph="X", cat="span", name=s.name, pid=pid, tid=tid, ts=(s.start_ns - base_ns) / 1e3,
                dur=(s.end_ns - s.start_ns) / 1e3, args=dict(s.ids, id=s.id, parent=s.parent, call=s.call))
           for s in rec.spans]
    out += [dict(ph="i", s="t", cat="count", name=c.name, pid=pid, tid=tid, ts=(c.t_ns - base_ns) / 1e3,
                 args=dict(n=c.n, span=c.span)) for c in rec.counts]
    return out
