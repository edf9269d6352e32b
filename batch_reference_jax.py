#!/usr/bin/env python3
"""Reference numbers for the batch paths' gates in `chip_smoke.py`.

    JAX_PLATFORMS=cpu python3 batch_reference_jax.py [--config lines|full|lost|async]
                                                     [--n-seq 8] [--frames 25] [--seqs 0,5]
                                                     [--port-renders] [--port-cpu]
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
`use_local_ba=False` and with `use_local_ba=True`. `--config lost` (the
batch-lost check): `BatchTracker(tum3_config(), 2)` with its defaults over
the orbits of seeds 0 and 1, sequence 1 given blank frames (uniform gray
120, zero depth) at frames 6 and 7; the JAX batch steps a LOST sequence
from its motion model inside the batch, with no relocalization. Adds each
sequence's per-frame states, its final trajectory (`T_wc`, the 4x4
camera-to-world matrix of every frame, row-major, chained through the
keyframe poses as local BA left them) and the pose each frame was tracked
at (`T_cw_tracked`, world-to-camera, before any later BA).
`--config async` (the batch_async phase): `BatchTracker(tum3_config(),
n_seq)` with its defaults (local BA on, triangulation on), the first frame
through `track_batch` with the ground-truth initial poses, the rest through
`track_batch_async` at pipeline depths 1 and 2, then `flush()`; per depth
and sequence the ATE RMSE, and the results returned. `--seqs` picks orbits
(seeds) instead of 0 .. n_seq - 1.
`--port-renders` takes the frames from the port's renderer
(`hfvo_tpu_torch.testing.synthetic` on the CPU: the frames `chip_smoke.py`'s
batch_lost tracks) instead of the JAX package's, which differs from it by
up to 0.021 gray levels. With `--port-cpu` it also runs the port's
`hfvo_tpu_torch` BatchTracker on the CPU over the same frames and prints,
per sequence and frame, both states, the gap between the two tracked poses
and between the two final poses (mm, degrees), and each final pose's
distance to the ground truth (about 6 min on 8 CPU cores).

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


def run(BatchTracker, cfg, seqs, use_local_ba, blank=()):
    """One batch run; `blank` (seq, frame) pairs get a uniform gray frame
    with zero depth."""
    from hfvo_tpu.io import evaluate

    S, n = len(seqs), len(seqs[0][1])
    bt = BatchTracker(cfg, n_seq=S, use_local_ba=use_local_ba)
    lines = np.zeros((S, n), int)
    planes = np.zeros((S, n), int)
    lost = np.zeros(S, int)
    kfs = np.zeros(S, int)
    states = [[] for _ in range(S)]
    tracked = [[] for _ in range(S)]
    t0 = time.perf_counter()
    for i in range(n):
        inits = [np.linalg.inv(seqs[s][0][0]) for s in range(S)] if i == 0 else None
        grays = [np.full_like(q[1][i], 120.0) if (s, i) in blank else q[1][i] for s, q in enumerate(seqs)]
        depths = [np.zeros_like(q[2][i]) if (s, i) in blank else q[2][i] for s, q in enumerate(seqs)]
        res = bt.track_batch(grays, depths, inits)
        for s, (r, tr) in enumerate(zip(res, bt.trackers)):
            states[s].append(r.state.name)
            tracked[s].append(np.asarray(r.T_cw).tolist())
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
        "states": states,
        "T_wc": [np.asarray(est).tolist() for est in bt.get_trajectories()] if blank else None,
        "T_cw_tracked": tracked if blank else None,
    }


def run_async(BatchTracker, cfg, seqs, depth):
    """`track_batch_async` at `depth` after an initializing `track_batch`."""
    from hfvo_tpu.io import evaluate

    S, n = len(seqs), len(seqs[0][1])
    bt = BatchTracker(cfg, n_seq=S, pipeline_depth=depth)
    t0 = time.perf_counter()
    n_res = len(bt.track_batch([q[1][0] for q in seqs], [q[2][0] for q in seqs],
                               [np.linalg.inv(q[0][0]) for q in seqs]))
    for i in range(1, n):
        n_res += len(bt.track_batch_async([q[1][i] for q in seqs], [q[2][i] for q in seqs]))
    n_res += len(bt.flush())
    ts = np.arange(n) / 30.0
    return {
        "pipeline_depth": depth, "results": n_res, "seconds": time.perf_counter() - t0,
        "ate_rmse_m": [float(evaluate.ate(ts, q[0], ts, est, align="origin").rmse)
                       for q, est in zip(seqs, bt.get_trajectories())],
        "keyframes": [int(tr.vomap.kf_order_counter) for tr in bt.trackers],
        "n_ba_runs": [int(tr.mapper.n_ba_runs) for tr in bt.trackers],
    }


def port_cpu(seqs, blank, jax_result) -> dict:
    """The port's BatchTracker(tum3_config(), 2) on the CPU over the frames
    of `run`, compared frame by frame with the JAX run's poses."""
    from hfvo_tpu_torch.config import tum3_config
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.parallel.multiseq import BatchTracker

    S, n = len(seqs), len(seqs[0][1])
    bt = BatchTracker(tum3_config(), S, "cpu")
    states, tracked = [[] for _ in range(S)], [[] for _ in range(S)]
    for i in range(n):
        inits = [np.linalg.inv(q[0][0]) for q in seqs] if i == 0 else None
        grays = [np.full_like(q[1][i], 120.0) if (s, i) in blank else q[1][i] for s, q in enumerate(seqs)]
        depths = [np.zeros_like(q[2][i]) if (s, i) in blank else q[2][i] for s, q in enumerate(seqs)]
        for s, r in enumerate(bt.track_batch(grays, depths, inits)):
            states[s].append(r.state.name)
            tracked[s].append(np.asarray(r.T_cw, np.float64))
    ts = np.arange(n) / 30.0
    trajs = bt.get_trajectories()

    def gap(Ta, Tb):
        """Two world-to-camera poses apart, as chip_smoke.py's pose_gap reads it."""
        D = Ta @ np.linalg.inv(Tb)
        rot = np.degrees(np.arctan2(0.5 * np.linalg.norm([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]]),
                                    0.5 * (np.trace(D[:3, :3]) - 1)))
        return f"{1e3 * np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]):.3f} mm {rot:.4f} deg"

    for s, (q, est) in enumerate(zip(seqs, trajs)):
        J, Jt = np.asarray(jax_result["T_wc"][s]), np.asarray(jax_result["T_cw_tracked"][s])
        for i in range(n):
            print(f"seq {s} frame {i:2d} JAX {jax_result['states'][s][i]:4s} port {states[s][i]:4s} "
                  f"tracked gap {gap(tracked[s][i], Jt[i])}, final gap {gap(np.linalg.inv(est[i]), np.linalg.inv(J[i]))}; "
                  f"final to the truth JAX {1e3 * np.linalg.norm(J[i][:3, 3] - q[0][i][:3, 3]):.3f} mm "
                  f"port {1e3 * np.linalg.norm(est[i][:3, 3] - q[0][i][:3, 3]):.3f} mm")
    return {
        "ate_rmse_m": [float(evaluate.ate(ts, q[0], ts, est, align="origin").rmse) for q, est in zip(seqs, trajs)],
        "states": states,
        "T_cw_tracked": [np.asarray(t).tolist() for t in tracked],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("lines", "full", "lost", "async"), default="lines")
    ap.add_argument("--n-seq", type=int, default=8)
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--seqs", default=None, help="--config async: comma-separated orbit seeds")
    ap.add_argument("--port-renders", action="store_true",
                    help="--config lost: track the port's renders of the orbits")
    ap.add_argument("--port-cpu", action="store_true",
                    help="--config lost: also run the port on the CPU and print per-frame gaps")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from hfvo_tpu.config import tum3_config
    from hfvo_tpu.parallel.multiseq import BatchTracker
    from hfvo_tpu.testing import synthetic

    c = tum3_config()
    tracking = dataclasses.replace(c.tracking, triangulate_new_points=False, triangulate_new_lines=False)
    if args.config == "lost":
        n = args.frames
        if args.port_renders:
            from hfvo_tpu_torch.testing import synthetic as port_synthetic

            seqs = [port_synthetic.render_sequence(n=n, seed=s) for s in (0, 1)]
        else:
            seqs = [synthetic.render_sequence(n=n, seed=s) for s in (0, 1)]
        result = {"config": "lost", "port_renders": args.port_renders, "n_seq": 2, "frames": n,
                  "blank": [[1, 6], [1, 7]],
                  **run(BatchTracker, c, seqs, True, blank={(1, 6), (1, 7)})}
        if args.port_cpu:
            result["port_cpu"] = port_cpu(seqs, {(1, 6), (1, 7)}, result)
        print(json.dumps(result))
        if args.out:
            with open(args.out, "w") as f:
                f.write(json.dumps(result) + "\n")
        return 0
    if args.config == "async":
        ids = [int(x) for x in args.seqs.split(",")] if args.seqs else list(range(args.n_seq))
        seqs = [synthetic.render_sequence(n=args.frames, seed=s) for s in ids]
        result = {"config": "async", "seqs": ids, "frames": args.frames,
                  "depths": [run_async(BatchTracker, c, seqs, depth) for depth in (1, 2)]}
        print(json.dumps(result))
        if args.out:
            with open(args.out, "w") as f:
                f.write(json.dumps(result) + "\n")
        return 0
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
