"""PnP: camera pose from 2D-3D correspondences, vectorized RANSAC.

Port of `hfvo_tpu.solve.pnp` (reference: src/PnPsolver.cc:67-477, EPnP
inside an adaptive RANSAC, used only by relocalization,
src/Tracking.cc:3805-3830). All hypotheses are sampled up front; each
minimal set of 6 contributes four pose candidates to one scoring pass: a
6-point DLT (the smallest eigenvector of a 12x12 normal matrix, rotation
projected onto SO(3)) and the three EPnP beta cases (`_epnp_pose`). The
winner is refined by the pose LM (`solve.lm.pose_optimization`), the
reference's final `refine()`.

As for `solve.ransac`, the solver is split into a core that takes the
sample indices (`pnp_ransac_core`) and a wrapper that draws them
(`pnp_ransac`). The null vectors come from batched `torch.linalg.eigh`,
whose sign and order within near-equal eigenvalues may differ from
XLA's; the DLT fixes its sign by the points' depth and EPnP by
cheirality, so candidates are comparable only after those fixes, and the
result is held by its chosen pose and inlier count.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import camera, se3
from ..geometry.camera import Intrinsics
from .lm import PoseObs, pose_optimization
from .ransac import draw_samples, kabsch

N_HYP = 96
MIN_SET = 6

# Control-point index pairs for the 6 pairwise distances (PnPsolver's
# compute_rho / compute_L_6x10 ordering, src/PnPsolver.cc:389-439).
_PAIR_I = (0, 0, 0, 1, 1, 2)
_PAIR_J = (1, 2, 3, 2, 3, 3)


class PnPResult(NamedTuple):
    T_cw: torch.Tensor  # (4, 4)
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int64
    ok: torch.Tensor  # () bool


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _solve(A, b):
    """A^-1 b without the error check (and its host sync) of
    `torch.linalg.solve`; a singular A gives non-finite values, as in XLA."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def _dlt_pose(X: torch.Tensor, xy_n: torch.Tensor) -> torch.Tensor:
    """DLT for T_cw from >= 6 points. X (*B, M, 3) world, xy_n (*B, M, 2)
    normalized image coords. Returns (*B, 4, 4) with R projected onto SO(3)."""
    zeros = torch.zeros(X.shape[:-1] + (4,), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)  # (*B, M, 4)
    rows_u = torch.cat([Xh, zeros, -xy_n[..., 0:1] * Xh], dim=-1)
    rows_v = torch.cat([zeros, Xh, -xy_n[..., 1:2] * Xh], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)  # (*B, 2M, 12)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    p = V[..., :, 0].reshape(V.shape[:-2] + (3, 4))
    # Fix the sign so the points are in front.
    depth_sign = torch.sign(torch.sum(Xh @ p[..., 2, :, None], dim=(-2, -1)))
    p = p * torch.where(depth_sign == 0, torch.ones_like(depth_sign), depth_sign)[..., None, None]
    R_raw = p[..., :3]
    # Scale from the rotation part, then project to SO(3).
    scale = torch.exp(torch.mean(torch.log(torch.clamp(torch.linalg.norm(R_raw, dim=-1), min=1e-12)), dim=-1))
    R = se3.orthonormalize(R_raw / scale[..., None, None])
    t = p[..., 3] / scale[..., None]
    return se3.rt_to_mat(R, t)


def _epnp_pose(X: torch.Tensor, xy_n: torch.Tensor) -> torch.Tensor:
    """EPnP for minimal sets X (*B, M, 3), xy_n (*B, M, 2): (*B, 3, 4, 4)
    pose candidates (beta cases N = 1, 2, 3, each Gauss-Newton refined;
    reference: PnPsolver::compute_pose, src/PnPsolver.cc:180-220)."""
    M = X.shape[-2]
    # 1. Control points: centroid + principal axes scaled by the square root
    #    of the per-point scatter eigenvalues, floored so the barycentric
    #    basis stays invertible for planar sets (choose_control_points,
    #    src/PnPsolver.cc:240-270).
    c0 = torch.mean(X, dim=-2)
    Xc = X - c0[..., None, :]
    scatter = Xc.transpose(-1, -2) @ Xc
    w_eig, V = torch.linalg.eigh(scatter)  # ascending
    tr = torch.diagonal(scatter, dim1=-2, dim2=-1).sum(-1)
    k = torch.sqrt(torch.maximum(w_eig, 1e-6 * tr[..., None] + 1e-12) / M)
    ctrl_w = torch.cat([c0[..., None, :], c0[..., None, :] + k[..., :, None] * V.transpose(-1, -2)], dim=-2)

    # 2. Barycentric coordinates (src/PnPsolver.cc:272-295).
    B = (ctrl_w[..., 1:, :] - ctrl_w[..., :1, :]).transpose(-1, -2)  # columns = basis vectors
    a123 = torch.linalg.solve_ex(B, Xc.transpose(-1, -2))[0].transpose(-1, -2)  # (*B, M, 3)
    alpha = torch.cat([1.0 - torch.sum(a123, dim=-1, keepdim=True), a123], dim=-1)  # (*B, M, 4)

    # 3. The 2M x 12 M-matrix in normalized coords (fill_M,
    #    src/PnPsolver.cc:297-313) and its null-space basis.
    zeros = torch.zeros_like(alpha)
    row_u = torch.stack([alpha, zeros, -alpha * xy_n[..., 0:1]], dim=-1)
    row_v = torch.stack([zeros, alpha, -alpha * xy_n[..., 1:2]], dim=-1)
    lead = alpha.shape[:-2]
    Mm = torch.cat([row_u.reshape(lead + (M, 12)), row_v.reshape(lead + (M, 12))], dim=-2)
    _, V12 = torch.linalg.eigh(Mm.transpose(-1, -2) @ Mm)
    vs = V12[..., :, :4].transpose(-1, -2).reshape(lead + (4, 4, 3))  # (basis k, ctrl j, xyz)

    # 4. Pairwise-distance data for the beta solves (compute_rho +
    #    compute_L_6x10, src/PnPsolver.cc:389-439).
    pi, pj = list(_PAIR_I), list(_PAIR_J)
    dv = vs[..., pi, :] - vs[..., pj, :]  # (*B, 4, 6, 3)
    D = torch.einsum("...kpi,...lpi->...pkl", dv, dv)  # (*B, 6, 4, 4)
    dw = torch.sum((ctrl_w[..., pi, :] - ctrl_w[..., pj, :]) ** 2, dim=-1)  # (*B, 6)

    def lstsq_reg(L, y):
        Lt = L.transpose(-1, -2)
        return _solve(Lt @ L + 1e-9 * _eye(L.shape[-1], L), (Lt @ y[..., None])[..., 0])

    zero = torch.zeros_like(dw[..., 0])
    # find_betas_approx_1 (src/PnPsolver.cc:441-460): b11 only.
    b11 = torch.sum(D[..., 0, 0] * dw, dim=-1) / torch.clamp(torch.sum(D[..., 0, 0] ** 2, dim=-1), min=1e-12)
    beta1 = torch.stack([torch.sqrt(torch.abs(b11)), zero, zero, zero], dim=-1)
    # find_betas_approx_2 (src/PnPsolver.cc:462-487): [b11, b12, b22].
    L2 = torch.stack([D[..., 0, 0], 2.0 * D[..., 0, 1], D[..., 1, 1]], dim=-1)
    b2 = lstsq_reg(L2, dw)
    beta2 = torch.stack([
        torch.sqrt(torch.abs(b2[..., 0])),
        torch.sqrt(torch.abs(b2[..., 2])) * torch.sign(b2[..., 1]) * torch.sign(b2[..., 0]),
        zero, zero,
    ], dim=-1)
    # find_betas_approx_3 (src/PnPsolver.cc:489-519): [b11, b12, b22, b13, b23].
    L3 = torch.stack([D[..., 0, 0], 2.0 * D[..., 0, 1], D[..., 1, 1], 2.0 * D[..., 0, 2], 2.0 * D[..., 1, 2]],
                     dim=-1)
    b3 = lstsq_reg(L3, dw)
    s0 = torch.sign(b3[..., 0])
    beta3_1 = torch.sqrt(torch.abs(b3[..., 0]))
    beta3 = torch.stack([
        beta3_1,
        torch.sqrt(torch.abs(b3[..., 2])) * torch.sign(b3[..., 1]) * s0,
        b3[..., 3] / torch.clamp(beta3_1, min=1e-12) * s0,
        zero,
    ], dim=-1)

    # Gauss-Newton, 5 iterations on the 6 distance residuals (gauss_newton,
    # src/PnPsolver.cc:521-575), for the three cases at once.
    betas = torch.stack([beta1, beta2, beta3], dim=-2)  # (*B, 3, 4)
    D3 = D[..., None, :, :, :]
    dw3 = dw[..., None, :]
    eye4 = _eye(4, D)
    for _ in range(5):
        Db = torch.einsum("...pkl,...l->...pk", D3, betas)  # (*B, 3, 6, 4)
        r = dw3 - torch.einsum("...pk,...k->...p", Db, betas)
        J = 2.0 * Db
        Jt = J.transpose(-1, -2)
        betas = betas + _solve(Jt @ J + 1e-9 * eye4, (Jt @ r[..., None])[..., 0])

    # Camera-frame control points, the set's camera coordinates, and the
    # cheirality sign fix (compute_ccs / compute_pcs, src/PnPsolver.cc:222-238).
    ctrl_c = torch.einsum("...ck,...kjx->...cjx", betas, vs)  # (*B, 3, 4, 3)
    pc = alpha[..., None, :, :] @ ctrl_c  # (*B, 3, M, 3)
    sgn = torch.where(torch.sum(pc[..., 2], dim=-1) < 0, -1.0, 1.0)
    Xe = X[..., None, :, :].expand(pc.shape)
    return kabsch(pc * sgn[..., None, None], Xe, torch.ones_like(pc[..., 0]))


def pnp_ransac_core(
    X_w: torch.Tensor,  # (N, 3)
    uv: torch.Tensor,  # (N, 2) pixel observations
    valid: torch.Tensor,  # (N,)
    intr: Intrinsics,
    idx: torch.Tensor,  # (H, MIN_SET) sample indices
    reproj_th: float = 5.0,
    min_inliers: int = 12,
    T_init: Optional[torch.Tensor] = None,
) -> PnPResult:
    """PnP RANSAC on the given minimal sets (hfvo_tpu/solve/pnp.py:192-246).
    `T_init` (4, 4) joins the hypothesis pool when given: a coarse prior
    (the retrieved keyframe's pose during relocalization) covers the planar
    scenes where the 6-point DLT is degenerate."""
    N = X_w.shape[0]
    f = torch.tensor([intr.fx, intr.fy], dtype=uv.dtype, device=uv.device)
    c = torch.tensor([intr.cx, intr.cy], dtype=uv.dtype, device=uv.device)
    xy_n = (uv - c) / f
    Xs, xs = X_w[idx], xy_n[idx]  # (H, 6, 3), (H, 6, 2)
    T_dlt = _dlt_pose(Xs, xs)
    T_epnp = _epnp_pose(Xs, xs)  # (H, 3, 4, 4)
    T_h = [T_dlt, T_epnp.reshape(-1, 4, 4)]
    if T_init is not None:
        T_h.append(T_init[None].to(X_w.dtype))
    T_h = torch.cat(T_h, dim=0)

    X_c = torch.einsum("hij,nj->hni", T_h[:, :3, :3], X_w) + T_h[:, None, :3, 3]
    err = torch.linalg.norm(camera.project(intr, X_c) - uv[None], dim=-1)
    inl = (err < reproj_th) & (X_c[..., 2] > 0.05) & valid[None, :]
    best = torch.argmax(torch.sum(inl, dim=1))  # the first maximum, as jnp.argmax
    T_best = T_h[best]
    best_inl = inl[best]

    # Refine with the shared pose LM on the inliers (mono edges).
    obs = torch.cat([uv, -torch.ones_like(uv[:, :1])], dim=1)
    pts = PoseObs(
        X_w=X_w, obs=obs, is_stereo=torch.zeros_like(valid),
        inv_sigma2=torch.ones_like(uv[:, 0]), valid=best_inl,
    )
    T_fit = pose_optimization(T_best, pts, intr, n_rounds=2, n_iters=8).T_cw
    X_cf = se3.transform(T_fit, X_w)
    err_f = torch.linalg.norm(camera.project(intr, X_cf) - uv, dim=-1)
    final = (err_f < reproj_th) & (X_cf[:, 2] > 0.05) & valid
    n = torch.sum(final)
    return PnPResult(T_fit, final, n, (n >= min_inliers) & torch.isfinite(T_fit).all())


def pnp_ransac(
    X_w: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    intr: Intrinsics,
    seed: int,
    reproj_th: float = 5.0,
    min_inliers: int = 12,
    T_init: Optional[torch.Tensor] = None,
) -> PnPResult:
    """`pnp_ransac_core` on N_HYP minimal sets of MIN_SET drawn by
    `solve.ransac.draw_samples` with `seed`."""
    idx = draw_samples(valid, N_HYP, MIN_SET, seed)
    return pnp_ransac_core(X_w, uv, valid, intr, idx, reproj_th, min_inliers, T_init)
