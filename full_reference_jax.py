#!/usr/bin/env python3
"""Reference numbers for the full and default paths' gates in `chip_smoke.py`.

    JAX_PLATFORMS=cpu python3 full_reference_jax.py [--config full|default|cli|endurance|adversarial]
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

`--config cli` (the cli phase): the 16 frames of `tests/test_cli_e2e.py`'s
protocol (orbit seed 11), rendered by the port's renderer on the CPU
(`hfvo_tpu_torch.testing.synthetic`, as `chip_smoke.py` writes them),
written as a TUM directory (RGB PNGs of the uint8 gray, 16-bit depth PNGs
at DepthMapFactor 5000, the association file and that test's settings)
and run through `hfvo_tpu.cli.main` with `--loader python` (the loader the
card runs) and, where it builds, `--loader native`: the ATE RMSE
(origin-aligned) of each saved trajectory.

`--config endurance` (the endurance phase): the two protocols of
`tests/test_endurance.py` on the port's CPU renders: 320 frames of
points-only tracking with 24 keyframe slots (a keyframe at least every 8
frames, no sensor noise), and 300 frames of `tum3_config()` with local BA
and loop closing and `accuracy_bench.py`'s sensor model
(`corrupt_depth(quad_sigma=0.002)`, seed 0): ATE, OK and LOST frames,
keyframes inserted and live, the ATE of each 100-frame window, local BA
runs, loops closed, and seconds.

`--config adversarial` (the adversarial phase): the robustness protocols
of `tests/test_adversarial.py` and `tests/test_depth_stride.py` on the
port's CPU renders (`hfvo_tpu_torch.testing.adversarial.frames`: slanted
quads and spheres, tum1 distortion, noisy depth, low-texture slanted, ICL,
depth-upload strides 1 and 4), each tracked by a fresh JAX `Tracker` with
local BA on and loop closing off, started at the ground-truth pose of frame
0: ATE, LOST frames, keyframes, local BA runs, the final state and seconds;
then the Hough recall protocol of `tests/test_parity_deviations.py` with
the JAX package's `detect_lines` on the port's renders.
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


CLI_FRAMES = 16


# tests/test_cli_e2e.py's settings.
CLI_SETTINGS = """%YAML:1.0
Camera.fx: 535.4
Camera.fy: 539.2
Camera.cx: 320.1
Camera.cy: 247.6
Camera.width: 640
Camera.height: 480
Camera.fps: 30.0
Camera.bf: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def cli_record() -> dict:
    import tempfile

    from hfvo_tpu import cli, native
    from hfvo_tpu.io import evaluate, trajectory
    from hfvo_tpu_torch.testing import synthetic as port_synthetic

    T_wc, grays, depths = port_synthetic.render_sequence(n=CLI_FRAMES, seed=11)
    out = {"config": "cli", "frames": CLI_FRAMES}
    with tempfile.TemporaryDirectory() as d:
        port_synthetic.write_tum_sequence(d, grays, depths, CLI_SETTINGS)
        for loader in ("python", "native"):
            if loader == "native" and not native.native_available():
                out[loader] = {"build_error": native.build_error()}
                continue
            traj = os.path.join(d, f"traj_{loader}.txt")
            t0 = time.perf_counter()
            cli.main([os.path.join(d, "settings.yaml"), d, os.path.join(d, "assoc.txt"),
                      "--loader", loader, "--out", traj])
            ts, T_est = trajectory.load_tum(traj)
            ate = evaluate.ate(np.arange(CLI_FRAMES) / 30.0, T_wc, np.asarray(ts), np.asarray(T_est),
                               align="origin")
            out[loader] = {"ate_rmse_m": float(ate.rmse), "frames": len(ts),
                           "seconds": time.perf_counter() - t0}
    return out


def endurance_record() -> dict:
    import torch

    from hfvo_tpu.config import Capacities, tum3_config
    from hfvo_tpu.io import evaluate
    from hfvo_tpu.tracking.tracker import Tracker
    from hfvo_tpu_torch.config import tum3_config as port_tum3
    from hfvo_tpu_torch.testing import endurance as port_endurance
    from hfvo_tpu_torch.testing import synthetic as port_synthetic

    def frames(n, step):
        T_wc = port_synthetic.orbit_trajectory(n, step=step)
        scene = port_synthetic.make_room(0, True)
        for i in range(n):
            g, d = port_synthetic.render(scene, port_tum3().camera, torch.from_numpy(T_wc[i]))
            yield T_wc, g.numpy(), d.numpy()

    out = {"config": "endurance"}
    n = 320
    cfg = tum3_config().replace(use_lines=False, use_planes=False, use_manhattan=False,
                                cap=Capacities(keyframes=24))
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, max_frames_between_kf=8))
    tr = Tracker(cfg, use_loop_closing=False)
    n_ok = 0
    t0 = time.perf_counter()
    for T_wc, g, d in frames(n, 2 * np.pi / 150.0):
        n_ok += tr.track_rgbd(g, d).state.name == "OK"
    traj = tr.get_trajectory()
    ts = np.arange(n) / 30.0
    out["points_past_kf_capacity"] = {
        "frames": n, "ok": int(n_ok), "kf_live": int(tr.vomap.n_keyframes()),
        "kf_total": int(tr.vomap.kf_order_counter),
        "ate_rmse_m": float(evaluate.ate(ts, T_wc, ts[: len(traj)], traj, align="origin").rmse),
        "seconds": time.perf_counter() - t0}
    n = 300
    tr = Tracker(tum3_config(), use_local_ba=True, use_loop_closing=True)
    rng = np.random.default_rng(0)
    lost = 0
    t0 = time.perf_counter()
    for T_wc, g, d in frames(n, 2 * np.pi / 100.0):
        g, d = port_endurance.sensorize(g, d, rng)
        lost += tr.track_rgbd(g, d, T_cw_init=np.linalg.inv(T_wc[0])).state.name != "OK"
    est = tr.get_trajectory()
    ts = np.arange(n) / 30.0
    win = [float(evaluate.ate(ts[s:s + 100], T_wc[s:s + 100], ts[s:s + 100], est[s:s + 100],
                              align="origin").rmse) for s in range(0, n - 99, 100)]
    out["full_stack_300"] = {
        "frames": n, "lost": int(lost), "kf_total": int(tr.vomap.kf_order_counter),
        "kf_live": int(tr.vomap.n_keyframes()), "n_ba_runs": int(tr.mapper.n_ba_runs),
        "loops_closed": int(tr.loop_closer.n_loops_closed),
        "ate_rmse_m": float(evaluate.ate(ts, T_wc, ts, est, align="origin").rmse),
        "drift_per_window_m": win, "seconds": time.perf_counter() - t0}
    return out


def adversarial_record() -> dict:
    import jax.numpy as jnp

    from hfvo_tpu import config as jax_config
    from hfvo_tpu.io import evaluate
    from hfvo_tpu.ops.lines import detect_lines
    from hfvo_tpu.tracking.tracker import Tracker
    from hfvo_tpu_torch.testing import adversarial

    out = {"config": "adversarial"}
    for name in adversarial.PROTOCOLS:
        pcfg = adversarial.config(name)
        cfg = {"distortion": jax_config.tum1_config, "icl": jax_config.icl_config}.get(name, jax_config.tum3_config)()
        cfg = cfg.replace(tracking=dataclasses.replace(
            cfg.tracking, depth_upload_stride=pcfg.tracking.depth_upload_stride))
        T_wc, grays, depths = adversarial.frames(name, "cpu")
        tr = Tracker(cfg, use_local_ba=True, use_loop_closing=False)
        lost = kfs = 0
        t0 = time.perf_counter()
        for g, d in zip(grays, depths):
            r = tr.track_rgbd(g, d, T_cw_init=np.linalg.inv(T_wc[0]))
            lost += r.state.name != "OK"
            kfs += bool(r.is_keyframe)
        n = len(grays)
        ts = np.arange(n) / 30.0
        out[name] = {"frames": n, "ate_rmse_m": float(evaluate.ate(ts, T_wc, ts, tr.get_trajectory(),
                                                                    align="origin").rmse),
                     "lost": lost, "keyframes": kfs, "n_ba_runs": int(tr.mapper.n_ba_runs),
                     "state": tr.state.name, "seconds": time.perf_counter() - t0}
        print(json.dumps({name: out[name]}), flush=True)
    import torch

    from hfvo_tpu_torch.config import tum3_config as port_tum3
    from hfvo_tpu_torch.testing import synthetic as port_synthetic

    cam = port_tum3().camera
    scene = port_synthetic.make_room(0, low_texture=True)
    segs = adversarial.gt_world_segments(scene.textures.numpy())
    T_wc = port_synthetic.orbit_trajectory(12)
    recalls = []
    for i in adversarial.RECALL_VIEWS:
        g, d = port_synthetic.render(scene, cam, torch.from_numpy(T_wc[i]))
        gt2d = adversarial.visible_gt_2d(segs, T_wc[i], cam, d.numpy())
        if len(gt2d) < 4:
            continue
        lf = detect_lines(jnp.asarray(g.numpy(), jnp.float32))
        recalls.append(adversarial.recall(gt2d, *(np.asarray(a) for a in (lf.valid, lf.p0, lf.p1, lf.line2d))))
    out["hough_recall"] = recalls
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("full", "default", "cli", "endurance", "adversarial"), default="full")
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
    if args.config in ("cli", "endurance", "adversarial"):
        result = {"cli": cli_record, "endurance": endurance_record, "adversarial": adversarial_record}[args.config]()
        out = json.dumps(result)
        print(out)
        if args.out:
            with open(args.out, "w") as f:
                f.write(out + "\n")
        return 0
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
