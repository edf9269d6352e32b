#!/usr/bin/env python3
"""Reference numbers for the full path's gates in `chip_smoke.py`.

    JAX_PLATFORMS=cpu python3 full_reference_jax.py [--frames 25] [--out FILE]

Runs the JAX package's `hfvo_tpu.tracking.tracker.Tracker.track_rgbd` on the
CPU over the frames `chip_smoke.py` tracks on its full path:
`render_sequence(n=frames, seed=0)`, tum3 with lines, planes and Manhattan
axes on (the JAX package's default step) and triangulation off,
`use_local_ba=False`, `use_loop_closing=False`, started from the identity
pose as `VOSystem.track_rgbd` starts. Prints one JSON line: ATE RMSE
(origin-aligned), LOST frames, keyframes, the first frame with a valid
Manhattan frame, the inlier full plane matches (an observed plane
associated with a map plane and kept by the pose LM) over frames
1 .. frames-1, and the inlier line matches over the same frames, each also
per frame.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from hfvo_tpu.config import tum3_config
    from hfvo_tpu.io import evaluate
    from hfvo_tpu.testing import synthetic
    from hfvo_tpu.tracking.tracker import Tracker

    c = tum3_config()
    cfg = c.replace(tracking=dataclasses.replace(
        c.tracking, triangulate_new_points=False, triangulate_new_lines=False))
    assert cfg.use_lines and cfg.use_planes and cfg.use_manhattan
    n = args.frames
    T_wc, grays, depths = synthetic.render_sequence(n=n, seed=0)
    tr = Tracker(cfg, use_local_ba=False, use_loop_closing=False)
    lost = kfs = 0
    manh, planes, lines = [], [], []
    t0 = time.perf_counter()
    for i in range(n):
        r = tr.track_rgbd(grays[i], depths[i])
        lost += r.state.name != "OK"
        kfs += bool(r.is_keyframe)
        manh.append(bool(tr.manh_valid))
        seg, _, kind, inlier = tr._last_plane_out
        planes.append(int((np.asarray(seg.valid) & (np.asarray(kind) == 0) & np.asarray(inlier)).sum()))
        llo = tr._last_line_out
        lines.append(0 if llo is None else int((np.asarray(llo[2]) >= 0).sum()))
    secs = time.perf_counter() - t0
    ts = np.arange(n) / 30.0
    ate = float(evaluate.ate(ts, T_wc, ts, tr.get_trajectory(), align="origin").rmse)
    out = json.dumps({
        "frames": n, "ate_rmse_m": ate, "lost": lost, "keyframes": kfs,
        "manh_first_valid_frame": manh.index(True) if any(manh) else None,
        "full_plane_inliers": sum(planes[1:]), "full_plane_inliers_per_frame": planes,
        "line_inliers": sum(lines[1:]), "line_inliers_per_frame": lines,
        "map_planes": int(tr.vomap.planes.valid.sum()), "seconds": secs,
    })
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
