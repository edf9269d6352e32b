#!/usr/bin/env python3
"""Where a tracked frame's time goes in the PyTorch/CUDA port, on the GPU.

    python3 profile_torch_step.py [--config points|lines] [--frames 10:20] [--out FILE]

Two systems track the same 25 rendered 640x480 frames (tum3, points-only or
point + line, as `chip_smoke.py` runs them) in one process:

- pass A runs without the profiler and times each frame on the host clock;
- pass B runs the same frames and wraps the chosen ones in `torch.profiler`,
  with a `record_function` range around each stage of the fused step.

It prints one JSON line: per frame, A's wall ms, B's wall ms, the device
busy ms (the union of B's kernel, copy and fill intervals) and the count of
those device ops; A's median over all tracked frames; the device idle share against A's wall time (against B's too);
and per stage its host ms under the profiler and the device ms of the
kernels it launched. `--out` also writes the profiler's
`key_averages()` table there. Needs one CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

N_FRAMES = 25
def _stage_sites():
    """(module, function name) of each stage the fused step calls, through
    the module attribute it calls it by."""
    from hfvo_tpu_torch.ops import lines, lines3d, lk, structural
    from hfvo_tpu_torch.tracking import matcher, tracker

    return (
        (tracker, "extract_frame"), (tracker, "compute_words"),
        (matcher, "search_by_projection"), (lines, "detect_lines"),
        (lines3d, "fit_lines_3d"), (structural, "line_opt_struct"),
        (matcher, "search_lines_by_projection"), (matcher, "search_lines_f2f"),
        (lk, "recover_lines_by_flow"), (tracker, "pose_optimization"),
    )


STAGES = (
    "extract_frame", "compute_words", "search_by_projection", "detect_lines",
    "fit_lines_3d", "line_opt_struct", "search_lines_by_projection",
    "search_lines_f2f", "recover_lines_by_flow", "pose_optimization",
)


def _wrap_stages():
    """Put a `record_function` range named after the stage around each stage
    function the fused step calls."""

    def wrap(name, fn):
        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return wrapped

    for mod, name in _stage_sites():
        setattr(mod, name, wrap(name, getattr(mod, name)))


def _busy_us(events) -> float:
    """Length of the union of the device intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
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
    return total


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("points", "lines"), default="points",
                    help="points-only or point + line tracking")
    ap.add_argument("--frames", default="10:20", help="profiled frames, start:stop")
    ap.add_argument("--out", default=None, help="file for the key_averages() table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    lo, hi = (int(v) for v in args.frames.split(":"))
    if not 1 <= lo < hi <= N_FRAMES:
        raise SystemExit(f"--frames must lie within 1:{N_FRAMES}")

    import hfvo_tpu_torch  # noqa: F401  (fp32 policy)
    from hfvo_tpu_torch.config import points_and_lines, points_only, tum3_config
    from hfvo_tpu_torch.system import VOSystem
    from hfvo_tpu_torch.testing import synthetic
    from hfvo_tpu_torch.tracking.tracker import TrackState

    _wrap_stages()
    device = torch.device("cuda", 0)
    cfg = (points_and_lines if args.config == "lines" else points_only)(tum3_config())
    _, grays, depths = synthetic.render_sequence(n=N_FRAMES, seed=0, device=device)

    def new_system():
        return VOSystem(cfg, device, use_local_ba=False, use_loop_closing=False)

    # Pass A: host clock only.
    sys_a, wall_a = new_system(), []
    for i in range(N_FRAMES):
        t0 = time.perf_counter()
        res = sys_a.track_rgbd(grays[i], depths[i], i / 30.0)
        wall_a.append(time.perf_counter() - t0)
        if res.state is not TrackState.OK:
            raise AssertionError(f"pass A: frame {i} is {res.state.name}")

    # Pass B: the same frames, frames lo..hi-1 under the profiler.
    sys_b = new_system()
    for i in range(lo):
        sys_b.track_rgbd(grays[i], depths[i], i / 30.0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(lo, hi):
            sys_b.track_rgbd(grays[i], depths[i], i / 30.0)
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0

    n = hi - lo
    # Kernels, copies and fills; not the device-side mirror of a stage range,
    # which spans the gaps between its kernels.
    dev_events = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.key not in STAGES and not getattr(e, "is_user_annotation", False)
    ]
    busy_ms = _busy_us(dev_events) / 1e3 / n
    wall_a_ms = float(np.mean(wall_a[lo:hi])) * 1e3
    wall_b_ms = wall_b * 1e3 / n
    stages = {}
    for evt in prof.key_averages():
        if evt.key in STAGES and evt.device_type == torch.autograd.DeviceType.CPU:
            stages[evt.key] = {"host_ms": evt.cpu_time_total / 1e3 / n,
                               "device_ms": _device_us(evt) / 1e3 / n}
    if args.out:
        with open(args.out, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60))
    print(json.dumps({
        "config": args.config,
        "card": torch.cuda.get_device_name(0),
        "frames": [lo, hi],
        "wall_ms_unprofiled": wall_a_ms,
        "wall_ms_unprofiled_median_tracked": float(np.median(wall_a[1:])) * 1e3,
        "wall_ms_profiled": wall_b_ms,
        "device_busy_ms": busy_ms,
        "idle_share_vs_unprofiled_wall": 1.0 - busy_ms / wall_a_ms,
        "idle_share_vs_profiled_wall": 1.0 - busy_ms / wall_b_ms,
        "device_ops_per_frame": len(dev_events) / n,
        "stages_per_frame": stages,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
