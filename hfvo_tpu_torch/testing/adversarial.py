"""The robustness protocols of the JAX suite on the port.

Ports of the scenes and gates of tests/test_adversarial.py (slanted quads
and spheres, tum1 lens distortion, quadratic depth noise with holes,
low-texture walls with slanted quads, the ICL preset's negative fy with
depth round-tripped at factor 5000), tests/test_depth_stride.py (the
subsampled depth upload at strides 1 and 4, from uint8 gray and uint16
millimetre depth) and the Hough recall protocol of
tests/test_parity_deviations.py (tiled-Hough segments against the exact
stripe borders of the low-texture room).

Each tracking protocol runs a fresh `Tracker` through `track_rgbd`, started
at the ground-truth pose of frame 0; (a)-(e) with local BA on and loop
closing off, as the JAX suite runs them. Frames are rendered on the
tracker's device; noise is drawn on the host from the JAX suite's seeds.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import VOConfig, icl_config, tum1_config, tum3_config
from ..io import evaluate
from ..tracking.tracker import Tracker, TrackState
from . import synthetic

# name: (frames, the ATE gate in metres, what the JAX suite's test checks)
PROTOCOLS = {
    "slanted": (25, 0.03, "test_adversarial.py::test_non_manhattan_slanted_structure"),
    "distortion": (20, 0.03, "test_adversarial.py::test_lens_distortion_end_to_end"),
    "noisy_depth": (25, 0.045, "test_adversarial.py::test_depth_noise_and_holes"),
    "low_texture_slanted": (25, 0.06, "test_adversarial.py::test_low_texture_non_manhattan"),
    "icl": (8, 0.02, "test_adversarial.py::test_icl_preset_negative_fy_end_to_end"),
    "stride1": (18, 0.02, "test_depth_stride.py::test_stride1_golden"),
    "stride4": (18, None, "test_depth_stride.py::test_stride4_bounded_degradation"),
}
# Stride 4 may lose at most this much ATE against stride 1 (metres).
STRIDE4_SLACK_M = 0.02
# The scenes with slanted quads and spheres (make_adversarial_room).
SCENES = {
    "slanted": dict(seed=3, n_slanted=2, n_spheres=3),
    "low_texture_slanted": dict(seed=9, n_slanted=2, n_spheres=2, low_texture=True),
}


def config(name: str) -> VOConfig:
    """The protocol's configuration."""
    if name == "distortion":
        return tum1_config()
    if name == "icl":
        return icl_config()
    cfg = tum3_config()
    if name.startswith("stride"):
        cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, depth_upload_stride=int(name[6:])))
    return cfg


def frames(name: str, device="cpu"):
    """(T_wc (n, 4, 4), grays, depths) of the protocol as its JAX test makes
    them, rendered on `device`; gray and depth float32 numpy, except the
    stride protocols' sensor format (uint8 gray, uint16 millimetres)."""
    n = PROTOCOLS[name][0]
    cam = config(name).camera
    if name in SCENES:
        scene = synthetic.make_adversarial_room(**SCENES[name], device=device)
        return synthetic.render_sequence(n=n, scene=scene, seed=SCENES[name]["seed"], device=device)
    if name == "distortion":
        return synthetic.render_sequence(n=n, intr=cam, seed=5, distort=True, device=device)
    if name == "noisy_depth":
        T_wc, grays, depths = synthetic.render_sequence(n=n, seed=6, device=device)
        rs = np.random.default_rng(6)
        return T_wc, grays, [synthetic.corrupt_depth(d, rs, quad_sigma=0.006) for d in depths]
    if name == "icl":
        T_wc, grays, depths = synthetic.render_sequence(n=n, seed=4, intr=cam, device=device)
        # Depth round-tripped through the dataset's integer format.
        return T_wc, grays, [
            np.clip(d * 5000.0, 0, 65535).astype(np.uint16).astype(np.float32) / 5000.0 for d in depths
        ]
    T_wc, grays, depths = synthetic.render_sequence(n=n, seed=3, device=device)
    return (T_wc, [np.clip(np.rint(g), 0, 255).astype(np.uint8) for g in grays],
            [np.clip(d * 1000.0, 0, 65535).astype(np.uint16) for d in depths])


def track(name: str, seq, device="cuda") -> dict:
    """Track the protocol's frames on a fresh Tracker; its record: ATE RMSE
    (origin-aligned), LOST frames, keyframes, local BA runs, the final
    state, the median and p90 ms of a tracked frame (frames 1..), the
    single-frame extractions (initializations, relocalizations) and fused
    steps the tracker ran."""
    T_wc, grays, depths = seq
    tr = Tracker(config(name), device, use_local_ba=True, use_loop_closing=False)
    T0 = np.linalg.inv(T_wc[0])
    states, kfs, secs = [], 0, []
    for g, d in zip(grays, depths):
        t0 = time.perf_counter()
        r = tr.track_rgbd(g, d, T_cw_init=T0)
        secs.append(time.perf_counter() - t0)
        states.append(r.state)
        kfs += bool(r.is_keyframe)
    est = tr.get_trajectory()
    n = len(grays)
    ts = np.arange(n) / 30.0
    ms = np.array(secs[1:]) * 1e3
    st = tr.stage_times
    return {
        "name": name, "frames": n,
        "ate_rmse_m": float(evaluate.ate(ts, T_wc, ts, est, align="origin").rmse),
        "lost": int(sum(s is not TrackState.OK for s in states)), "keyframes": kfs,
        "n_ba_runs": int(tr.mapper.n_ba_runs), "state": tr.state.name,
        "finite": bool(np.isfinite(est).all() and est.shape == (n, 4, 4)),
        "ms_median": float(np.median(ms)), "ms_p90": float(np.percentile(ms, 90)),
        "inits": st.get("init_extract", [0, 0])[1], "relocalizations": st.get("relocalize", [0, 0])[1],
        "steps": st.get("fused_step", [0, 0])[1],
    }


def failures(rec: dict, stride1_ate: float | None = None) -> list:
    """The JAX suite's gates the record misses (empty when it passes)."""
    name = rec["name"]
    gate = PROTOCOLS[name][1]
    out = []
    if not rec["finite"]:
        out.append("non-finite trajectory")
    if gate is not None and not rec["ate_rmse_m"] < gate:
        out.append(f"ATE {rec['ate_rmse_m']:.6f} m not under {gate} m")
    if name == "icl" and rec["state"] != "OK":
        out.append(f"final state {rec['state']}")
    if name.startswith("stride") and rec["lost"]:
        out.append(f"{rec['lost']} frames not OK")
    if name == "stride4" and not rec["ate_rmse_m"] <= stride1_ate + STRIDE4_SLACK_M:
        out.append(f"ATE {rec['ate_rmse_m']:.6f} m above stride 1's {stride1_ate:.6f} + {STRIDE4_SLACK_M} m")
    return out


# The Hough recall protocol (tests/test_parity_deviations.py:132-258), numpy.
RECALL_VIEWS = tuple(range(0, 12, 3))
RECALL_MEAN, RECALL_MIN = 0.75, 0.60


def gt_world_segments(textures: np.ndarray) -> list:
    """Exact 3D stripe-border segments of the room's six faces: the
    textures paint stripes at 20.0 along full texture rows or columns, and
    each stripe boundary is a world segment on the face plane."""
    segs = []
    for fid, (axis, sign) in enumerate(synthetic._FACES):
        ext = sign * synthetic._EXTENT[fid]
        ua, va = synthetic._UVAXES[fid]
        su, sv = synthetic._UVSPAN[fid]
        t = textures[fid]
        for mask, span_const, span_free, free_ax, const_ax in (
            ((t == 20.0).all(axis=1), sv, su, ua, va),  # texture rows
            ((t == 20.0).all(axis=0), su, sv, va, ua),  # texture columns
        ):
            d = np.diff(mask.astype(np.int8))
            for e in np.concatenate([np.nonzero(d == 1)[0] + 0.5, np.nonzero(d == -1)[0] + 0.5]):
                c = e / (synthetic.TEX - 1) * 2 * span_const - span_const
                p0, p1 = np.zeros(3), np.zeros(3)
                p0[axis] = p1[axis] = ext
                p0[const_ax] = p1[const_ax] = c
                p0[free_ax], p1[free_ax] = -span_free, span_free
                segs.append((p0, p1))
    return segs


def visible_gt_2d(segs, T_wc, intr, depth: np.ndarray, min_px: float = 60.0) -> list:
    """Project the segments and keep, per segment, the longest contiguous
    run of samples that are in the frame and on the nearest surface
    (against the rendered depth); (S, 2) pixel samples per visible segment
    at least `min_px` long."""
    T_cw = np.linalg.inv(np.asarray(T_wc, np.float64))
    Rr, tt = T_cw[:3, :3], T_cw[:3, 3]
    h, w = depth.shape
    out = []
    for p0, p1 in segs:
        s = np.linspace(0.0, 1.0, 161)
        Pc = (p0[None] + s[:, None] * (p1 - p0)[None]) @ Rr.T + tt
        z = Pc[:, 2]
        ok = z > 0.05
        u = np.where(ok, intr.fx * Pc[:, 0] / np.where(ok, z, 1) + intr.cx, -1)
        v = np.where(ok, intr.fy * Pc[:, 1] / np.where(ok, z, 1) + intr.cy, -1)
        m = 6
        ok &= (u >= m) & (u < w - m) & (v >= m) & (v < h - m)
        ui = np.clip(np.round(u).astype(int), 0, w - 1)
        vi = np.clip(np.round(v).astype(int), 0, h - 1)
        ok &= np.abs(depth[vi, ui] - z) < 0.01 * z + 0.02  # nearest hit
        best, cur = (0, 0), None
        for i, o in enumerate(ok):
            if o and cur is None:
                cur = i
            if (not o or i == len(ok) - 1) and cur is not None:
                end = i + 1 if o else i
                if end - cur > best[1] - best[0]:
                    best = (cur, end)
                cur = None
        a, b = best
        if b - a < 3:
            continue
        pts = np.stack([u[a:b], v[a:b]], axis=1)
        if np.linalg.norm(pts[-1] - pts[0]) >= min_px:
            out.append(pts)
    return out


def recall(gt_pts_list, valid, p0, p1, line2d, max_perp=3.0, max_ang=np.deg2rad(5), min_ov=0.5) -> float:
    """Share of the visible segments that a detected segment recalls: within
    5 deg of its direction, within 3 px of it on average, and covering at
    least half of its extent."""
    p0, p1, coef = p0[valid], p1[valid], line2d[valid]
    det_d = p1 - p0
    det_ang = np.arctan2(det_d[:, 1], det_d[:, 0]) % np.pi
    hits = 0
    for pts in gt_pts_list:
        g = pts[-1] - pts[0]
        g_len = np.linalg.norm(g)
        g_dir = g / g_len
        d_ang = np.abs(det_ang - np.arctan2(g[1], g[0]) % np.pi)
        d_ang = np.minimum(d_ang, np.pi - d_ang)
        perp = np.abs(coef[:, :2] @ pts.T + coef[:, 2:3]).mean(axis=1)
        t0 = (p0 - pts[0]) @ g_dir / g_len
        t1 = (p1 - pts[0]) @ g_dir / g_len
        ov = np.minimum(np.maximum(t0, t1), 1.0) - np.maximum(np.minimum(t0, t1), 0.0)
        if ((d_ang < max_ang) & (perp < max_perp) & (ov > min_ov)).any():
            hits += 1
    return hits / max(len(gt_pts_list), 1)


def hough_recall(device="cuda") -> list:
    """The recall of `detect_lines` (kernel K3 on the card) on views 0, 3, 6
    and 9 of the low-texture room's 12-frame orbit, rendered on `device`;
    views with fewer than 4 visible segments are skipped, as in the JAX
    test."""
    from ..ops.batch import resolve_device, to_host
    from ..ops.lines import detect_lines

    device = resolve_device(device)
    cam = tum3_config().camera
    scene = synthetic.make_room(0, low_texture=True, device=device)
    segs = gt_world_segments(scene.textures.cpu().numpy())
    T_wc = synthetic.orbit_trajectory(12)
    out = []
    for i in RECALL_VIEWS:
        g, d = synthetic.render(scene, cam, torch.from_numpy(T_wc[i]))
        gt2d = visible_gt_2d(segs, T_wc[i], cam, d.cpu().numpy())
        if len(gt2d) < 4:
            continue
        lf = detect_lines(g.float())
        out.append(recall(gt2d, *to_host([lf.valid, lf.p0, lf.p1, lf.line2d])))
    return out


def recall_failures(recalls: list) -> list:
    out = []
    if len(recalls) < 3:
        out.append(f"{len(recalls)} views with 4 visible segments, under 3")
    elif not (np.mean(recalls) >= RECALL_MEAN and min(recalls) >= RECALL_MIN):
        out.append(f"recall mean {np.mean(recalls):.4f} (gate {RECALL_MEAN}), min {min(recalls):.4f} "
                   f"(gate {RECALL_MIN})")
    return out
