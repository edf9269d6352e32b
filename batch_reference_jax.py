#!/usr/bin/env python3
"""Reference numbers for the batch paths' gates in `chip_smoke.py`.

    JAX_PLATFORMS=cpu python3 batch_reference_jax.py [--config lines|full]
                                                     [--n-seq 8] [--frames 25]
                                                     [--out FILE]

Runs the JAX package's `hfvo_tpu.parallel.multiseq.BatchTracker.track_batch`
on the CPU over the sequences `chip_smoke.py` tracks as a batch:
`render_sequence(n=frames, seed=s)` for s = 0 .. n_seq - 1, each sequence
initialized at its first frame with the ground-truth pose, triangulation off
(the synchronous batch path never triangulates).

`--config lines` (the batch path): tum3 with lines on and planes and
Manhattan off, `use_local_ba=False`. `--config full` (the batch-full and
batch-BA phases): `tum3_config()`'s step (lines, planes and Manhattan axes
on, the JAX benchmark's batch configuration), run twice, with
`use_local_ba=False` and with `use_local_ba=True`.

Prints one JSON line: per run and sequence its ATE RMSE (origin-aligned),
its inlier line matches and inlier full plane matches over frames
1 .. frames-1, LOST frames, keyframes and local BA runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def run(BatchTracker, cfg, seqs, use_local_ba):
    from hfvo_tpu.io import evaluate

    S, n = len(seqs), len(seqs[0][1])
    bt = BatchTracker(cfg, n_seq=S, use_local_ba=use_local_ba)
    lines = np.zeros((S, n), int)
    planes = np.zeros((S, n), int)
    lost = np.zeros(S, int)
    kfs = np.zeros(S, int)
    t0 = time.perf_counter()
    for i in range(n):
        inits = [np.linalg.inv(seqs[s][0][0]) for s in range(S)] if i == 0 else None
        res = bt.track_batch([q[1][i] for q in seqs], [q[2][i] for q in seqs], inits)
        for s, (r, tr) in enumerate(zip(res, bt.trackers)):
            lost[s] += r.state.name != "OK"
            kfs[s] += bool(r.is_keyframe)
            llo = tr._last_line_out
            lines[s, i] = 0 if llo is None else int((np.asarray(llo[2]) >= 0).sum())
            po = tr._last_plane_out
            planes[s, i] = 0 if po is None else int(
                (np.asarray(po[0].valid) & (np.asarray(po[2]) == 0) & np.asarray(po[3])).sum())
    ts = np.arange(n) / 30.0
    ate = [
        float(evaluate.ate(ts, seqs[s][0], ts, est, align="origin").rmse)
        for s, est in enumerate(bt.get_trajectories())
    ]
    return {
        "use_local_ba": use_local_ba, "seconds": time.perf_counter() - t0,
        "ate_rmse_m": ate, "line_inliers_frames_1_on": lines[:, 1:].sum(1).tolist(),
        "plane_inliers_frames_1_on": planes[:, 1:].sum(1).tolist(),
        "lost": lost.tolist(), "keyframes": kfs.tolist(),
        "n_ba_runs": [int(tr.mapper.n_ba_runs) for tr in bt.trackers],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("lines", "full"), default="lines")
    ap.add_argument("--n-seq", type=int, default=8)
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from hfvo_tpu.config import tum3_config
    from hfvo_tpu.parallel.multiseq import BatchTracker
    from hfvo_tpu.testing import synthetic

    c = tum3_config()
    tracking = dataclasses.replace(c.tracking, triangulate_new_points=False, triangulate_new_lines=False)
    if args.config == "lines":
        cfg = c.replace(use_lines=True, use_planes=False, use_manhattan=False, tracking=tracking)
        ba_modes = (False,)
    else:
        cfg = c.replace(tracking=tracking)
        assert cfg.use_lines and cfg.use_planes and cfg.use_manhattan
        ba_modes = (False, True)
    S, n = args.n_seq, args.frames
    seqs = [synthetic.render_sequence(n=n, seed=s) for s in range(S)]
    runs = [run(BatchTracker, cfg, seqs, ba) for ba in ba_modes]
    result = {"config": args.config, "n_seq": S, "frames": n, **runs[0]}
    if len(runs) > 1:
        result["local_ba"] = runs[1]
    out = json.dumps(result)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
