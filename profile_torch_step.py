#!/usr/bin/env python3
"""Where a tracked frame's time goes in the PyTorch/CUDA port, on the GPU.

    python3 profile_torch_step.py [--config points|lines|full|batch|fast] [--frames 10:20] [--out FILE]

`points`, `lines`, `full`: two systems track the same 25 rendered 640x480
frames (tum3, points-only, point + line, or the full step with lines,
planes and Manhattan axes, as `chip_smoke.py` runs them) in one process. `batch`: two `BatchTracker`s track 8 such sequences (orbits of
seeds 0-7, point + line) a call, as `chip_smoke.py`'s batch path does; a
"frame" below is then one call for the 8 sequences. In each:

- pass A runs without the profiler and times each frame on the host clock;
- pass B runs the same frames and wraps the chosen ones in `torch.profiler`,
  with a `record_function` range around each stage of the fused step.

It prints one JSON line: A's wall ms a frame over the chosen frames and
its median over all tracked frames, B's wall ms, the device busy ms (the
union of B's kernel, copy and fill intervals) and the count of those device
ops a frame; the device idle share against A's wall time (against B's too);
and per stage its host ms under the profiler and the device ms of the
kernels it launched.

`fast` times the JAX package's "pyramid + 2x fast_score all levels" probe
(profile_step.py:147-158) as the port runs it, `ops.fast.pyramid_fast_scores`
on one rendered 640x480 frame (kernel K2, one launch a threshold over all
8 levels: 2 a call), with the same two passes over 20 calls; a "frame" is
then one call.

`--out` also writes the profiler's `key_averages()` table there. Needs one
CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

N_FRAMES = 25
N_SEQ = 8


def _stage_sites():
    """(module, function name) of each stage the fused step calls, through
    the module attribute it calls it by. `_manhattan_prior` is the full
    step's normals + mean shift; `segment_planes` and `match_planes` its
    plane block; `pose_optimization` holds the plane and axis rows."""
    from hfvo_tpu_torch.ops import lines, lines3d, lk, planes, structural
    from hfvo_tpu_torch.tracking import matcher, tracker

    return (
        (tracker, "_manhattan_prior"),
        (tracker, "extract_frame"), (tracker, "compute_words"),
        (matcher, "search_by_projection"), (lines, "detect_lines"),
        (lines3d, "fit_lines_3d"), (structural, "line_opt_struct"),
        (matcher, "search_lines_by_projection"), (matcher, "search_lines_f2f"),
        (lk, "recover_lines_by_flow"), (planes, "segment_planes"),
        (matcher, "match_planes"), (tracker, "pose_optimization"),
    )


STAGES = (
    "_manhattan_prior", "extract_frame", "compute_words", "search_by_projection",
    "detect_lines", "fit_lines_3d", "line_opt_struct", "search_lines_by_projection",
    "search_lines_f2f", "recover_lines_by_flow", "segment_planes", "match_planes",
    "pose_optimization",
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


def _profile(step, lo, hi):
    """Pass B of `step` (a fresh runner's frame function): frames 0..lo-1
    unprofiled, lo..hi-1 under the profiler. Returns (profiler, wall ms a
    frame)."""
    for i in range(lo):
        step(i)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(lo, hi):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall * 1e3 / (hi - lo)


def _runners(config, device):
    """(number of frames, factory of a fresh frame function) for a config.
    A frame function runs frame i and checks its result."""
    from hfvo_tpu_torch.config import full_step, points_and_lines, points_only, tum3_config
    from hfvo_tpu_torch.testing import synthetic
    from hfvo_tpu_torch.tracking.tracker import TrackState

    if config == "fast":
        from hfvo_tpu_torch.ops import fast

        _, grays, _ = synthetic.render_sequence(n=1, seed=0, device=device)
        img = torch.from_numpy(np.clip(grays[0], 0, 255).astype(np.uint8)).to(device).float()
        orb = tum3_config().orb

        def factory():
            def step(i):
                fast.pyramid_fast_scores(img, float(orb.min_th_fast), float(orb.ini_th_fast),
                                         orb.n_levels, orb.scale_factor)
            return step
        return 20, factory

    cfg = {"points": points_only, "full": full_step}.get(config, points_and_lines)(tum3_config())
    if config == "batch":
        from hfvo_tpu_torch.parallel.multiseq import BatchTracker

        seqs = [synthetic.render_sequence(n=N_FRAMES, seed=s, device=device) for s in range(N_SEQ)]

        def factory():
            bt = BatchTracker(cfg, n_seq=N_SEQ, device=device, use_local_ba=False)

            def step(i):
                inits = [np.linalg.inv(q[0][0]) for q in seqs] if i == 0 else None
                res = bt.track_batch([q[1][i] for q in seqs], [q[2][i] for q in seqs], inits)
                if any(r.state is not TrackState.OK for r in res):
                    raise AssertionError(f"frame {i}: {[r.state.name for r in res]}")
            return step
        return N_FRAMES, factory

    from hfvo_tpu_torch.system import VOSystem

    _, grays, depths = synthetic.render_sequence(n=N_FRAMES, seed=0, device=device)

    def factory():
        system = VOSystem(cfg, device, use_local_ba=False, use_loop_closing=False)

        def step(i):
            res = system.track_rgbd(grays[i], depths[i], i / 30.0)
            if res.state is not TrackState.OK:
                raise AssertionError(f"frame {i} is {res.state.name}")
        return step
    return N_FRAMES, factory


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("points", "lines", "full", "batch", "fast"), default="points",
                    help="points-only, point + line, the full step, 8-sequence batch tracking, "
                         "or the FAST probe")
    ap.add_argument("--frames", default="10:20", help="profiled frames (calls), start:stop")
    ap.add_argument("--out", default=None, help="file for the key_averages() table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    lo, hi = (int(v) for v in args.frames.split(":"))

    import hfvo_tpu_torch  # noqa: F401  (fp32 policy)

    _wrap_stages()
    device = torch.device("cuda", 0)
    n_frames, factory = _runners(args.config, device)
    if not 1 <= lo < hi <= n_frames:
        raise SystemExit(f"--frames must lie within 1:{n_frames}")

    # Pass A: host clock only.
    step_a, wall_a = factory(), []
    for i in range(n_frames):
        t0 = time.perf_counter()
        step_a(i)
        torch.cuda.synchronize()
        wall_a.append(time.perf_counter() - t0)

    # Pass B: the same frames, frames lo..hi-1 under the profiler.
    prof, wall_b_ms = _profile(factory(), lo, hi)

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
        "frame_is": {"batch": f"one track_batch call for {N_SEQ} sequences",
                     "fast": "one pyramid_fast_scores call on a 640x480 frame"}.get(
                         args.config, "one tracked frame"),
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
