"""Trajectory evaluation CLI — the evo_ape protocol without external tools.

Port of `hfvo_tpu.eval_cli` (numpy, copied) on the port's `io.evaluate`
and `io.trajectory`; it prints the same text.

Equivalent of the reference's evaluation scripts (reference:
utils/EVO_APE.sh — `evo_ape tum <gt> <traj> -p --align_origin` per sequence;
utils/process_datasets.sh — batch over sequences).

Usage:
    python -m hfvo_tpu_torch.eval_cli GT_TUM EST_TUM [--align origin|umeyama|none]
    python -m hfvo_tpu_torch.eval_cli --batch PAIRS_FILE   # lines: gt est
"""
from __future__ import annotations

import argparse
import sys


def _eval_one(gt_path: str, est_path: str, align: str) -> dict:
    from .io import evaluate, trajectory

    t_gt, G = trajectory.load_tum(gt_path)
    t_est, E = trajectory.load_tum(est_path)
    ape = evaluate.ate(t_gt, G, t_est, E, align=align)
    rpe = evaluate.rpe(t_gt, G, t_est, E)
    return {
        "gt": gt_path,
        "est": est_path,
        "ape_rmse": ape.rmse,
        "ape_mean": ape.mean,
        "ape_median": ape.median,
        "ape_std": ape.std,
        "ape_min": ape.min,
        "ape_max": ape.max,
        "n_pairs": ape.n,
        "rpe_rmse": rpe.rmse,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("gt", nargs="?", help="ground-truth TUM trajectory")
    ap.add_argument("est", nargs="?", help="estimated TUM trajectory")
    ap.add_argument("--align", choices=["origin", "umeyama", "none"], default="origin")
    ap.add_argument("--batch", help="file of '<gt> <est>' pairs, one per line")
    args = ap.parse_args(argv)

    pairs = []
    if args.batch:
        with open(args.batch) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    pairs.append((parts[0], parts[1]))
    elif args.gt and args.est:
        pairs.append((args.gt, args.est))
    else:
        ap.error("provide GT and EST, or --batch")

    for gt, est in pairs:
        r = _eval_one(gt, est, args.align)
        print(
            f"{est}: APE rmse {r['ape_rmse']*100:.2f} cm  "
            f"mean {r['ape_mean']*100:.2f}  median {r['ape_median']*100:.2f}  "
            f"max {r['ape_max']*100:.2f}  (n={r['n_pairs']})  "
            f"RPE rmse {r['rpe_rmse']*100:.2f} cm"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
