"""The program's own spans and counters (`hfvo_tpu_torch.tracing`) in a
traced run, for the metric readers, and a breakdown of the traced slice by
span.

The recorder follows the profiler: every call into the system that starts
while the traced slice's profiler records keeps its spans and its
`host_sync` counts, and the per-name span totals are marked when recording
stops, at the first call after the slice. A program without the recorder
gives nothing to read (the readers return None).

    python hfvo_bench/spans.py --workload <cell> --seed <n> --seconds <s> [--recorder-on]

runs the cell as `run.py --trace 1` does and prints its result line with a
`span_breakdown`: the slice's device-idle time by the innermost span open
over it (`idle_by_span`, top 10, and the whole list's sum against the
slice's idle), device operations and seconds by the span whose runtime
call launched them (`ops_by_span`, top 10, matched by correlation id), one
frame's host syncs by span and by the line that synchronized, and the
clock check (`upload` spans holding the start of their pageable
host-to-device copy). It keeps the trace's CUDA runtime calls, which the
harness's reading of the trace drops, and moves device times onto the host
clock by the device's measured lag (`device_lag`). With `--recorder-on` it
instead runs `--trace 0` with the recorder on from the start, for the
recorder's cost against a run without it.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

_LAST: list = []  # [ctx, recording] of the run's traced slice, drained once
_RUNTIME: list = []  # (host start ns, correlation id, name) of the slice's CUDA runtime calls (spans.py runs)


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        from hfvo_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def slice_recording(ctx):
    """The spans and counts recorded in the traced slice (drained once a
    run), or None where nothing was recorded."""
    tr = recorder()
    if tr is None or ctx.trace is None:
        return None
    if not _LAST or _LAST[0] is not ctx:
        _LAST[:] = [ctx, tr.drain()]
    rec = _LAST[1]
    return rec if rec.spans else None


def after_slice(ctx, name: str):
    """(seconds, count) of span `name` over the calls after the traced
    slice, or None where the recorder never stopped there."""
    tr = recorder()
    if tr is None or ctx.trace is None or tr.enabled():
        return None
    return tr.totals(since_stop=True).get(name, (0.0, 0))


def facade_calls(rec) -> set:
    return {s.id for s in rec.spans if s.parent == 0 and s.name == "facade.track"}


def device_lag(events, launch: dict, lo: float, hi: float, n_win: int = 16):
    """The device clock's lag behind the host's over [lo, hi]: in each of
    `n_win` windows of launch time, the 1st percentile of device start less
    launch over the operations launched there (the device idles most of the
    time, so the fastest of them start within microseconds of their launch).
    Returns the windows' centres and lags (ns), or None."""
    import numpy as np

    pairs = np.array([(launch[c], s - launch[c]) for s, _, _, c in events if c in launch], float)
    if not len(pairs):
        return None
    edges = np.linspace(lo, hi, n_win + 1)
    cen, lag = [], []
    for a, b in zip(edges[:-1], edges[1:]):
        d = pairs[(pairs[:, 0] >= a) & (pairs[:, 0] < b), 1]
        if len(d) >= 20:
            cen.append(0.5 * (a + b))
            lag.append(float(np.percentile(d, 1)))
    return (np.array(cen), np.array(lag)) if cen else None


def breakdown(trace: dict, rec, k: int = 10, runtime=None) -> dict:
    """The slice's device trace placed on the recorded spans. With
    `runtime`, the CUDA runtime calls of the trace: a device operation is
    placed at the host time of the call that launched it (its correlation
    id), and device times are moved onto the host clock by the device's
    measured lag (`device_lag`); without it, at its device start, as the
    trace has it."""
    import bisect

    import numpy as np

    from hfvo_tpu_torch import tracing

    calls = facade_calls(rec)
    roots = [s for s in rec.spans if s.id in calls]
    # Nanoseconds from the first call's start (epoch nanoseconds as floats
    # would keep only ~256 ns).
    t0 = min(s.start_ns for s in roots)
    lo, hi = 0, max(s.end_ns for s in roots) - t0
    spans = [(s.start_ns - t0, s.end_ns - t0, s.name) for s in rec.spans]
    events = [(s * 1e3 - t0, e * 1e3 - t0, nm, c) for s, e, nm, c in trace["events"]]
    launch = {c: t - t0 for t, c, _ in runtime or ()}
    lag = device_lag(events, launch, lo, hi)
    if lag is not None:
        shift = np.interp([s for s, _, _, _ in events], *lag)
        events = [(s - float(d), e - float(d), nm, c) for (s, e, nm, c), d in zip(events, shift)]
    dev = [(s, e) for s, e, _, _ in events]
    idle = tracing.idle_by_span(dev, spans, lo, hi)
    idle_s = sum(e - s for s, e in tracing.idle_intervals(dev, lo, hi)) / 1e9
    ops = tracing.ops_by_span([(launch.get(c, s), (e - s) / 1e9) for s, e, _, c in events], spans, lo, hi)
    n_matched = sum(1 for _, _, _, c in events if c in launch)
    self_by = {n: v / 1e9 for n, v in idle.items()}

    # One frame in the middle of the slice: its host syncs by span and site.
    mid = sorted(roots, key=lambda s: s.start_ns)[len(roots) // 2]
    names = {s.id: s.name for s in rec.spans}
    one, sites, lm_tests = {}, {}, 0
    for c in rec.counts:
        if c.call != mid.id:
            continue
        if c.name == "lm_test":
            lm_tests += c.n
        elif c.name == "host_sync":
            nm = names.get(c.span, tracing.OUTSIDE)
            one[nm] = one.get(nm, 0) + c.n
            site = c.site.replace(str(ROOT) + "/", "") or nm
            sites[site] = sites.get(site, 0) + c.n

    # The clock: upload spans holding the start of a pageable copy to the
    # device (and of the runtime call that queued it), give or take 0.1 ms.
    # An upload of a view of pinned memory (a pulled result) copies from
    # pinned memory.
    copies = sorted(s for s, _, nm, _ in events if "Memcpy HtoD (Pageable" in nm)
    pinned = sorted(s for s, _, nm, _ in events if "Memcpy HtoD (Pinned" in nm)
    copy_calls = sorted(launch[c] for _, _, nm, c in events if "Memcpy HtoD" in nm and c in launch)
    ups = [s for s in rec.spans if s.name == "upload" and lo <= s.start_ns - t0 <= hi]

    def holds(starts, s):
        i = bisect.bisect_left(starts, s.start_ns - t0 - 1e5)
        return bool(i < len(starts) and starts[i] <= s.end_ns - t0 + 1e5)

    missed = {}
    for s in ups:
        if not holds(copies, s) and not holds(pinned, s):
            nm = names.get(s.parent, tracing.OUTSIDE)
            missed[nm] = missed.get(nm, 0) + 1
    clock = dict(uploads=len(ups), holding_a_pageable_copy=sum(holds(copies, s) for s in ups),
                 holding_a_pinned_copy=sum(holds(pinned, s) and not holds(copies, s) for s in ups),
                 missed_by_parent=missed)
    if lag is not None:
        clock.update(holding_its_runtime_call=sum(holds(copy_calls, s) for s in ups),
                     device_lag_us_first_last=[float(lag[1][0]) / 1e3, float(lag[1][-1]) / 1e3])
    return dict(
        slice_s=(hi - lo) / 1e9, idle_s=idle_s, idle_by_span_sum_s=sum(idle.values()) / 1e9,
        idle_by_span=[[n, v / 1e9] for n, v in tracing.top(idle, k)],
        outside_and_facade_share=(self_by.get(tracing.OUTSIDE, 0.0) + self_by.get("facade.track", 0.0)) / idle_s,
        fused_step_self_share=self_by.get("fused_step", 0.0) / idle_s,
        ops_by_span=tracing.top(ops, k),
        ops_by=f"launching runtime call for {n_matched} of {len(events)} ops, device start for the rest",
        host_syncs_one_frame=dict(frame=mid.ids, total=sum(one.values()), by_span=one, lm_tests=lm_tests,
                                  sites=dict(sorted(sites.items(), key=lambda kv: -kv[1])[:k])),
        clock=clock,
    )


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recorder-on", action="store_true")
    a = ap.parse_args(argv)
    import torch

    from hfvo_bench import run
    from hfvo_bench import spans as shared  # the module the readers import

    tr = recorder()
    if tr is None:
        print("hfvo_bench/spans.py: the program has no recorder", file=sys.stderr)
        return 4
    args = run.parse(["--workload", a.workload, "--seed", str(a.seed), "--seconds", str(a.seconds),
                      "--trace", "0" if a.recorder_on else "1"])
    if a.recorder_on:
        tr.enable()
    else:
        # Keep the slice's CUDA runtime calls, which the harness's reading
        # of the trace leaves out, for the correlation of ops to spans.
        from hfvo_bench import trace as htrace

        read = htrace.device_events

        def device_events(prof):
            raw = htrace._raw(prof) or []
            shared._RUNTIME[:] = [(e.start_ns(), e.correlation_id(), e.name()) for e in raw
                                  if e.device_type() != torch.autograd.DeviceType.CUDA and e.correlation_id()]
            return read(prof)

        htrace.device_events = device_events
    try:
        result, _, _ = run.run_cell(args)
    except run.RunError as e:
        print(f"hfvo_bench/spans.py: {e}", file=sys.stderr)
        return e.code
    if a.recorder_on:
        tr.disable()
        result["recorder"] = "on"
    elif shared._LAST:
        trace, rec = shared._LAST[0].trace, shared._LAST[1]
        if rec.spans:
            result["span_breakdown"] = breakdown(trace, rec, runtime=shared._RUNTIME)
    print(json.dumps(result, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
