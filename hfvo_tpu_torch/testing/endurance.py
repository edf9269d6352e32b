"""The endurance protocols of the JAX suite on the port.

Port of `accuracy_bench.run_sequence` (its sensor model: uint8 gray
quantization, `synthetic.corrupt_depth` with the published Kinect axial
noise, uint16 millimetre depth) and of the two protocols of
tests/test_endurance.py:
- `points_past_kf_capacity`: 320 frames of points-only tracking with 24
  keyframe slots and a keyframe at least every 8 frames, ~2 orbits, no
  sensor noise;
- `full_stack_300`: 300 frames of the complete default system (points,
  lines, planes, Manhattan axes, local BA, loop closing) over 3 orbits with
  the sensor model, and the ATE of each 100-frame window.
Frames are rendered on the tracker's device; the depth noise is drawn on
the host from `np.random.default_rng(0)`, as the JAX package draws it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import Capacities, VOConfig, tum3_config
from ..io import evaluate
from ..tracking.tracker import Tracker, TrackState
from . import synthetic


def sensorize(gray, depth, rng):
    """uint8 gray and uint16 millimetre depth, the depth corrupted by the
    published Kinect axial noise model (quad_sigma = 0.002) and dropout
    holes (accuracy_bench.py:40-53)."""
    g = np.clip(np.rint(np.asarray(gray)), 0, 255).astype(np.uint8)
    d = synthetic.corrupt_depth(np.asarray(depth), rng, quad_sigma=0.002)
    d = np.clip(d * 1000.0, 0, 65535).astype(np.uint16)
    return g, d


def run_sequence(cfg: VOConfig, scene, T_wc: np.ndarray, device, use_local_ba: bool,
                 use_loop_closing: bool, drift_win: int = 0) -> dict:
    """Track the rendered sequence with the sensor model (noise seed 0);
    the summary of accuracy_bench.run_sequence plus per-frame wall times
    (ms), the local BA and loop-closure runs and their mean ms."""
    rng = np.random.default_rng(0)
    tr = Tracker(cfg, device, use_local_ba=use_local_ba, use_loop_closing=use_loop_closing)
    n_lost = 0
    frame_ms = []
    t0 = time.perf_counter()
    for i in range(len(T_wc)):
        g, d = synthetic.render(scene, cfg.camera, torch.from_numpy(T_wc[i]))
        g, d = sensorize(g.cpu().numpy(), d.cpu().numpy(), rng)
        t1 = time.perf_counter()
        res = tr.track_rgbd(g, d, T_cw_init=np.linalg.inv(T_wc[0]))
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        n_lost += res.state is not TrackState.OK
    wall = time.perf_counter() - t0
    est = tr.get_trajectory()
    n = len(est)
    ts = np.arange(n) / 30.0
    ape = evaluate.ate(ts, T_wc[:n], ts, est, align="origin")
    st = tr.stage_times
    out = dict(
        ate_rmse=float(ape.rmse), n_frames=n, n_lost=int(n_lost), wall_s=wall,
        n_kf_total=int(tr.vomap.kf_order_counter), n_kf_live=int(tr.vomap.n_keyframes()),
        n_ba=int(tr.mapper.n_ba_runs), n_loops=int(tr.loop_closer.n_loops_closed),
        frame_ms_p50=float(np.percentile(frame_ms, 50)), frame_ms_p90=float(np.percentile(frame_ms, 90)),
        ba_ms=1e3 * st["local_ba"][0] / st["local_ba"][1] if "local_ba" in st else None,
        loop_ms=1e3 * st["loop_detect"][0] / st["loop_detect"][1] if "loop_detect" in st else None,
        traj_finite=bool(np.isfinite(est).all()),
    )
    if drift_win:
        # Per-window drift: each `drift_win`-frame window origin-aligned on
        # its own (accuracy_bench.py:80-90).
        drift = []
        for s in range(0, n - drift_win + 1, drift_win):
            e = slice(s, s + drift_win)
            drift.append(round(float(evaluate.ate(ts[e], T_wc[:n][e], ts[e], est[e], align="origin").rmse), 4))
        out["drift_per_window"] = drift
    return out


def points_past_kf_capacity(device, n: int = 320) -> dict:
    """tests/test_endurance.py::test_endurance_past_kf_capacity on the
    port: no sensor noise, the gray through the tracker's float path."""
    cfg = tum3_config().replace(use_lines=False, use_planes=False, use_manhattan=False,
                                cap=Capacities(keyframes=24))
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, max_frames_between_kf=8))
    T_wc = synthetic.orbit_trajectory(n, step=2 * np.pi / 150.0)
    scene = synthetic.make_room(0, True, device=device)
    tr = Tracker(cfg, device, use_loop_closing=False)
    n_ok = 0
    frame_ms = []
    for i in range(n):
        g, d = synthetic.render(scene, cfg.camera, torch.from_numpy(T_wc[i]))
        g, d = g.cpu().numpy(), d.cpu().numpy()
        t1 = time.perf_counter()
        res = tr.track_rgbd(g, d)
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        n_ok += res.state is TrackState.OK
    traj = tr.get_trajectory()
    ts = np.arange(n) / 30.0
    ape = evaluate.ate(ts, T_wc, ts[: len(traj)], traj, align="origin")
    return dict(n_frames=n, n_ok=int(n_ok), n_kf_live=int(tr.vomap.n_keyframes()),
                n_kf_total=int(tr.vomap.kf_order_counter), ate_rmse=float(ape.rmse),
                traj_finite=bool(np.isfinite(traj).all()),
                frame_ms_p50=float(np.percentile(frame_ms, 50)),
                frame_ms_p90=float(np.percentile(frame_ms, 90)))


def points_past_kf_capacity_ok(r: dict) -> bool:
    """The gates of test_endurance_past_kf_capacity."""
    return (r["n_ok"] >= int(0.97 * r["n_frames"]) and r["n_kf_live"] <= 24
            and r["n_kf_total"] > 24 and r["traj_finite"] and r["ate_rmse"] < 0.25)


def full_stack_300(device, n: int = 300) -> dict:
    """tests/test_endurance.py::test_endurance_full_stack_300 on the port."""
    T_wc = synthetic.orbit_trajectory(n, step=2 * np.pi / 100.0)
    scene = synthetic.make_room(0, stripes=True, device=device)
    return run_sequence(tum3_config(), scene, T_wc, device, use_local_ba=True,
                        use_loop_closing=True, drift_win=100)


def full_stack_300_ok(r: dict) -> bool:
    """The gates of test_endurance_full_stack_300."""
    return (r["n_lost"] == 0 and r["ate_rmse"] <= 0.05 and max(r["drift_per_window"]) <= 0.04
            and 8 <= r["n_kf_total"] <= 64)
