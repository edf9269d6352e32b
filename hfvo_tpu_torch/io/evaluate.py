"""Trajectory evaluation: ATE RMSE, evo-compatible.

The reference's accuracy protocol is `evo_ape tum <gt> <traj> --align_origin`
(reference: utils/EVO_APE.sh:2). This module reimplements that metric (plus
full Umeyama SE(3) alignment, evo's `-a` mode) so evaluation needs no external
tools: associate poses by nearest timestamp, align, report translational APE
statistics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class ApeResult:
    rmse: float
    mean: float
    median: float
    std: float
    min: float
    max: float
    n: int


def associate_by_time(
    t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """Index pairs (ia, ib) of mutually-nearest timestamps within max_dt."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(t_a):
        j = int(np.argmin(np.abs(t_b - t)))
        if abs(t_b[j] - t) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.array(ia, dtype=int), np.array(ib, dtype=int)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) transform aligning src->dst (N, 3)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        c = np.trace(np.diag(D) @ S) / var_s
    else:
        c = 1.0
    t = mu_d - c * R @ mu_s
    return c, R, t


def ate(
    t_gt: np.ndarray,
    T_gt_wc: np.ndarray,
    t_est: np.ndarray,
    T_est_wc: np.ndarray,
    align: str = "origin",
    max_dt: float = 0.02,
) -> ApeResult:
    """Absolute trajectory error of translation, after alignment.

    align: 'origin' (evo --align_origin: align first pose only),
           'umeyama' (evo -a: SE(3) LSQ), 'none'.
    """
    ig, ie = associate_by_time(t_gt, t_est, max_dt)
    if len(ig) == 0:
        raise ValueError("no timestamp associations between trajectories")
    G = np.asarray(T_gt_wc)[ig]
    E = np.asarray(T_est_wc)[ie]
    if align == "origin":
        # T_align = T_gt[0] @ inv(T_est[0]); applied to every estimated pose.
        T_align = G[0] @ np.linalg.inv(E[0])
        E = np.einsum("ij,njk->nik", T_align, E)
    elif align == "umeyama":
        _, R, t = umeyama_alignment(E[:, :3, 3], G[:, :3, 3], with_scale=False)
        E = E.copy()
        E[:, :3, 3] = (R @ E[:, :3, 3].T).T + t
        E[:, :3, :3] = np.einsum("ij,njk->nik", R, E[:, :3, :3])
    err = np.linalg.norm(G[:, :3, 3] - E[:, :3, 3], axis=1)
    return ApeResult(
        rmse=float(np.sqrt(np.mean(err ** 2))),
        mean=float(err.mean()),
        median=float(np.median(err)),
        std=float(err.std()),
        min=float(err.min()),
        max=float(err.max()),
        n=len(err),
    )


def rpe(
    t_gt: np.ndarray,
    T_gt_wc: np.ndarray,
    t_est: np.ndarray,
    T_est_wc: np.ndarray,
    delta: int = 1,
    max_dt: float = 0.02,
) -> ApeResult:
    """Relative pose error (translation part) over a frame delta."""
    ig, ie = associate_by_time(t_gt, t_est, max_dt)
    G = np.asarray(T_gt_wc)[ig]
    E = np.asarray(T_est_wc)[ie]
    errs = []
    for i in range(len(G) - delta):
        dg = np.linalg.inv(G[i]) @ G[i + delta]
        de = np.linalg.inv(E[i]) @ E[i + delta]
        rel = np.linalg.inv(dg) @ de
        errs.append(np.linalg.norm(rel[:3, 3]))
    err = np.array(errs)
    return ApeResult(
        rmse=float(np.sqrt(np.mean(err ** 2))),
        mean=float(err.mean()),
        median=float(np.median(err)),
        std=float(err.std()),
        min=float(err.min()),
        max=float(err.max()),
        n=len(err),
    )
