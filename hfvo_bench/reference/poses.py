"""Pose answers against the ground truth, in float64: the TUM RGB-D
benchmark's absolute trajectory error (Sturm et al., IROS 2012): the rigid
motion that best maps the returned camera centres onto the true ones
(Horn's closed form, as its evaluate_ate.py), then the root mean square of
the remaining distances.
"""
from __future__ import annotations

import numpy as np


def ate_rmse(T_wc_est: np.ndarray, T_wc_gt: np.ndarray) -> float:
    """ATE RMSE (m) of (N, 4, 4) camera-to-world poses, N >= 3."""
    p = np.asarray(T_wc_est, np.float64)[:, :3, 3]
    q = np.asarray(T_wc_gt, np.float64)[:, :3, 3]
    if not np.isfinite(p).all():
        return float("inf")
    mp, mq = p.mean(0), q.mean(0)
    U, _, Vt = np.linalg.svd((p - mp).T @ (q - mq))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    err = (R @ (p - mp).T).T + mq - q
    return float(np.sqrt((err ** 2).sum(1).mean()))


def rot_max_deg(T_wc_est: np.ndarray, T_wc_gt: np.ndarray) -> float:
    """The largest geodesic angle (degrees) between a returned camera
    orientation and the true one, after one rotation of the returned world
    onto the true one: the rotation nearest (in the Frobenius norm) to the
    sum of R_gt R_est^T over the frames."""
    Re = np.asarray(T_wc_est, np.float64)[:, :3, :3]
    Rg = np.asarray(T_wc_gt, np.float64)[:, :3, :3]
    if not np.isfinite(Re).all():
        return float("inf")
    U, _, Vt = np.linalg.svd(np.einsum("nij,nkj->ik", Rg, Re))
    G = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    D = np.einsum("nji,jk,nkl->nil", Rg, G, Re)  # R_gt^T G R_est
    # |D - I|_F = 2 sqrt(2) sin(angle / 2), exact also for small angles.
    s = np.linalg.norm(D - np.eye(3), axis=(1, 2)) / (2.0 * np.sqrt(2.0))
    return float(np.degrees(2.0 * np.arcsin(np.clip(s, 0.0, 1.0))).max())
