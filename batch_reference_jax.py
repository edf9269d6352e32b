#!/usr/bin/env python3
"""Reference numbers for the batch path's gates in `chip_smoke.py`.

    JAX_PLATFORMS=cpu python3 batch_reference_jax.py [--n-seq 8] [--frames 25]

Runs the JAX package's `hfvo_tpu.parallel.multiseq.BatchTracker.track_batch`
on the CPU over the sequences `chip_smoke.py` tracks as a batch:
`render_sequence(n=frames, seed=s)` for s = 0 .. n_seq - 1, tum3 with lines
on and planes, Manhattan and triangulation off, `use_local_ba=False`, each
sequence initialized at its first frame with the ground-truth pose. Prints
one JSON line: per sequence its ATE RMSE (origin-aligned), its inlier line
matches over frames 1 .. frames-1, LOST frames and keyframes.
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
    ap.add_argument("--n-seq", type=int, default=8)
    ap.add_argument("--frames", type=int, default=25)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from hfvo_tpu.config import tum3_config
    from hfvo_tpu.io import evaluate
    from hfvo_tpu.parallel.multiseq import BatchTracker
    from hfvo_tpu.testing import synthetic

    c = tum3_config()
    cfg = c.replace(
        use_lines=True, use_planes=False, use_manhattan=False,
        tracking=dataclasses.replace(c.tracking, triangulate_new_points=False,
                                     triangulate_new_lines=False),
    )
    S, n = args.n_seq, args.frames
    seqs = [synthetic.render_sequence(n=n, seed=s) for s in range(S)]
    bt = BatchTracker(cfg, n_seq=S, use_local_ba=False)
    lines = np.zeros((S, n), int)
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
    ts = np.arange(n) / 30.0
    ate = [
        float(evaluate.ate(ts, seqs[s][0], ts, est, align="origin").rmse)
        for s, est in enumerate(bt.get_trajectories())
    ]
    print(json.dumps({
        "n_seq": S, "frames": n, "seconds": time.perf_counter() - t0,
        "ate_rmse_m": ate, "line_inliers_frames_1_on": lines[:, 1:].sum(1).tolist(),
        "lost": lost.tolist(), "keyframes": kfs.tolist(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
