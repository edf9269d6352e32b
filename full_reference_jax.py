#!/usr/bin/env python3
"""Reference numbers for the full and default paths' gates in `chip_smoke.py`.

    JAX_PLATFORMS=cpu python3 full_reference_jax.py [--config full|default]
                                                    [--frames 25] [--out FILE]

Runs the JAX package's `hfvo_tpu.tracking.tracker.Tracker.track_rgbd` on the
CPU over the frames `chip_smoke.py` tracks: `render_sequence(n=frames,
seed=0)`, started from the identity pose as `VOSystem.track_rgbd` starts.

`--config full` (the full path): tum3 with lines, planes and Manhattan axes
on (the JAX package's default step), triangulation off,
`use_local_ba=False` and loop closing off. Prints one JSON line: ATE RMSE (origin-aligned), LOST
frames, keyframes, the first frame with a valid Manhattan frame, the inlier
full plane matches (an observed plane associated with a map plane and kept
by the pose LM) over frames 1 .. frames-1, and the inlier line matches over
the same frames, each also per frame.

`--config default` (the default and low-texture phases): `tum3_config()`
as it is on a `Tracker` with every default (local BA, loop closing and the
early-loss reset on: the JAX package's default system). The same numbers
for the orbit, with the local BA runs, the loops closed and the points and
lines triangulated; then the low-texture room of `tests/test_low_texture.py`
(`make_room(0, low_texture=True)`, 20 orbit frames, each run started at
the ground-truth pose of frame 0) tracked by a points-only configuration
(lines, planes and Manhattan off) and by `tum3_config()`, each on a fresh
tracker with the same defaults: their ATE RMSE. Last, the global BA as
`tests/test_global_ba.py:88-126` runs it (every keyframe pose but the
oldest's perturbed by a 1 cm / 0.01 rad twist of seed 7, then
`run_global_ba` gauged at the oldest) on that test's map
(`render_sequence(n=14, seed=3)`, a keyframe at least every 2 frames) and
on the low-texture hybrid run's final map: the median keyframe
translation error against the map before the perturbation, perturbed and
after, and the final cost.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def _counting(mapper, key, counts):
    """Wrap mapper.<key> so that each call's return value is appended to
    counts[key]."""
    fn = getattr(mapper, key)

    def wrapped(*a, **kw):
        n = fn(*a, **kw)
        counts.setdefault(key, []).append(int(n))
        return n

    setattr(mapper, key, wrapped)


def track(Tracker, cfg, T_wc, grays, depths, use_local_ba, init_pose=False, use_loop_closing=False, keep=None):
    """Track the frames on a fresh tracker; the JSON-ready record. The
    tracker goes into `keep[name]` when given (name: see main)."""
    tr = Tracker(cfg, use_local_ba=use_local_ba, use_loop_closing=use_loop_closing)
    made = {}
    _counting(tr.mapper, "create_new_map_points", made)
    _counting(tr.mapper, "create_new_map_lines", made)
    n = len(grays)
    init = np.linalg.inv(T_wc[0]) if init_pose else None
    lost = kfs = 0
    manh, planes, lines = [], [], []
    t0 = time.perf_counter()
    for i in range(n):
        r = tr.track_rgbd(grays[i], depths[i], T_cw_init=init)
        lost += r.state.name != "OK"
        kfs += bool(r.is_keyframe)
        manh.append(bool(tr.manh_valid))
        po = tr._last_plane_out
        planes.append(0 if po is None else int(
            (np.asarray(po[0].valid) & (np.asarray(po[2]) == 0) & np.asarray(po[3])).sum()))
        llo = tr._last_line_out
        lines.append(0 if llo is None else int((np.asarray(llo[2]) >= 0).sum()))
    secs = time.perf_counter() - t0
    if keep is not None:
        keep["points_only" if not cfg.use_lines else "hybrid"] = tr
    from hfvo_tpu.io import evaluate

    ts = np.arange(n) / 30.0
    ate = float(evaluate.ate(ts, T_wc[:n], ts, tr.get_trajectory(), align="origin").rmse)
    return {
        "frames": n, "ate_rmse_m": ate, "lost": lost, "keyframes": kfs,
        "manh_first_valid_frame": manh.index(True) if any(manh) else None,
        "full_plane_inliers": sum(planes[1:]), "full_plane_inliers_per_frame": planes,
        "line_inliers": sum(lines[1:]), "line_inliers_per_frame": lines,
        "map_planes": int(tr.vomap.planes.valid.sum()), "n_ba_runs": int(tr.mapper.n_ba_runs),
        "use_loop_closing": use_loop_closing, "loops_closed": int(tr.loop_closer.n_loops_closed),
        "points_triangulated_per_kf": made.get("create_new_map_points", []),
        "lines_triangulated_per_kf": made.get("create_new_map_lines", []),
        "seconds": secs,
    }


def gba_record(vomap, cam) -> dict:
    """The global BA of tests/test_global_ba.py:88-126 on a copy of `vomap`."""
    import copy

    import jax.numpy as jnp

    from hfvo_tpu.geometry import se3
    from hfvo_tpu.solve.global_ba import run_global_ba

    vm = copy.deepcopy(vomap)
    kf = vm.keyframes
    slots = np.nonzero(kf.valid)[0]
    T_before = kf.T_cw[slots].copy()
    gauge = int(slots[np.argsort(kf.order[slots], kind="stable")[0]])
    rs = np.random.default_rng(7)
    for s in slots:
        if s != gauge:
            xi = (rs.normal(size=6) * 0.01).astype(np.float32)
            kf.T_cw[s] = np.asarray(se3.exp_se3(jnp.asarray(xi))) @ kf.T_cw[s]

    def median_err():
        return float(np.median(np.linalg.norm(kf.T_cw[slots][:, :3, 3] - T_before[:, :3, 3], axis=1)))

    before = median_err()
    chi2 = run_global_ba(vm, cam, gauge_kf=gauge)
    return {"keyframes": len(slots), "median_error_perturbed_m": before, "median_error_after_m": median_err(),
            "chi2": float(chi2)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("full", "default"), default="full")
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--low-texture-frames", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from hfvo_tpu.config import tum3_config
    from hfvo_tpu.testing import synthetic
    from hfvo_tpu.tracking.tracker import Tracker

    c = tum3_config()
    assert c.use_lines and c.use_planes and c.use_manhattan
    T_wc, grays, depths = synthetic.render_sequence(n=args.frames, seed=0)
    if args.config == "full":
        cfg = c.replace(tracking=dataclasses.replace(
            c.tracking, triangulate_new_points=False, triangulate_new_lines=False))
        result = track(Tracker, cfg, T_wc, grays, depths, use_local_ba=False)
    else:
        assert c.tracking.triangulate_new_points and c.tracking.triangulate_new_lines
        result = {"config": "default", "orbit": track(Tracker, c, T_wc, grays, depths, use_local_ba=True,
                                                       use_loop_closing=True)}
        n = args.low_texture_frames
        T_lt = synthetic.orbit_trajectory(n)
        scene = synthetic.make_room(0, low_texture=True)
        lt = [synthetic.render_jit(scene, c.camera, jax.numpy.asarray(T_lt[i])) for i in range(n)]
        g_lt = [np.asarray(g) for g, _ in lt]
        d_lt = [np.asarray(d) for _, d in lt]
        pts = c.replace(use_lines=False, use_planes=False, use_manhattan=False)
        trackers = {}
        result["low_texture"] = {
            key: track(Tracker, cfg_lt, T_lt, g_lt, d_lt, use_local_ba=True, init_pose=True, use_loop_closing=True,
                       keep=trackers)
            for key, cfg_lt in (("points_only", pts), ("hybrid", c))
        }
        T_g, g_g, d_g = synthetic.render_sequence(n=14, seed=3)
        cfg_g = c.replace(tracking=dataclasses.replace(c.tracking, max_frames_between_kf=2))
        tr_g = Tracker(cfg_g, use_local_ba=False, use_loop_closing=False)
        for i in range(14):
            tr_g.track_rgbd(g_g[i], d_g[i], T_cw_init=np.linalg.inv(T_g[0]))
        result["global_ba"] = {"test_global_ba": gba_record(tr_g.vomap, c.camera),
                               "low_texture": gba_record(trackers["hybrid"].vomap, c.camera)}
    out = json.dumps(result)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
