"""Pose-graph optimization: matrix-free LM-CG over relative SE(3) edges.

Port of `hfvo_tpu.solve.pose_graph` on one device (reference:
`Optimizer::OptimizeEssentialGraph`, src/Optimizer.cc:4339, with the scale
fixed as the reference fixes it for RGB-D). Edges carry a measured
relative pose T_ij ~ T_i T_j^{-1} (camera-from-world). Each LM iteration
linearizes every edge at delta = 0 around the current poses, with per-edge
(6, 12) Jacobians by vmapped forward-mode autodiff (`torch.func`, as
`jax.vmap(jax.jacfwd(...))` in the JAX package), and solves the normal
equations by block-Jacobi-preconditioned CG whose matvec is two edge-local
products and scatter-adds; the (6K, 6K) Hessian is never formed.

The iteration counts are fixed (20 LM iterations of 60 CG steps) and the
accept and convergence decisions are `torch.where`s on the device, so the
loops never synchronize with the host. `reduce` is the JAX package's
`axis_name` form: with the edge table split over ranks
(`parallel/dist_pose_graph.py`), every edge-indexed sum is reduced over the
ranks where `_pg_impl` applies `_ps`, so each rank computes the same update.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..geometry import se3
from ..ops import sym_eig


class PoseGraph(NamedTuple):
    T_cw: torch.Tensor  # (K, 4, 4) initial keyframe poses
    free: torch.Tensor  # (K,) bool; False: fixed (gauge / padding)
    e_i: torch.Tensor  # (E,) int64
    e_j: torch.Tensor  # (E,) int64
    e_Tij: torch.Tensor  # (E, 4, 4) measured T_i @ inv(T_j)
    e_weight: torch.Tensor  # (E,) edge weights (0 = padding)


def _log_se3(T):
    """`se3.log_se3` with V^-1 t by the closed-form 3x3 inverse instead of
    `torch.linalg.solve`: the solve's forward-mode derivative is wrong
    under `torch.func.vmap` (held by the Jacobian test), and its error
    check would synchronize with the host. V is well conditioned (det V
    >= 4 / pi^2 over the angles a log returns)."""
    w = se3.log_so3(T[..., :3, :3])
    rho = (sym_eig.inv3x3(se3._so3_V(w)) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, w], dim=-1)


def _edge_residual(d12, T_i, T_j, Tij_inv, w):
    """r(delta) (6,) for one edge at the current poses; d12 = [d_i, d_j].
    Every intermediate keeps a leading axis of 1, as in the JAX package:
    under `torch.func.jacfwd` a 0-dim tensor times a Python float gives a
    float64 tangent."""
    D_i = se3.exp_se3(d12[None, :6])
    D_j = se3.exp_se3(d12[None, 6:])
    rel = (D_i @ T_i) @ se3.inv(D_j @ T_j)
    return (_log_se3(Tij_inv @ rel) * w)[0]


_edge_residuals = torch.func.vmap(_edge_residual)
_edge_jacobians = torch.func.vmap(torch.func.jacfwd(_edge_residual))


def optimize_pose_graph(pg: PoseGraph, n_iters: int = 20, cg_iters: int = 60,
                        reduce: Optional[Callable[..., list]] = None) -> torch.Tensor:
    """Corrected poses (K, 4, 4) (hfvo_tpu/solve/pose_graph.py:49-157).
    `reduce(*xs)` sums each tensor over the ranks of an edge-sharded solve
    (`Mesh.psum_all`); None on one device."""
    ps = reduce or (lambda *xs: list(xs))
    T0 = pg.T_cw
    K, E = T0.shape[0], pg.e_i.shape[0]
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    Tij_inv = se3.inv(pg.e_Tij)
    freem = pg.free[:, None].to(T0.dtype)
    zeros12 = T0.new_zeros((E, 12))

    def scatter(vals_i, vals_j):
        out = T0.new_zeros((K,) + vals_i.shape[1:])
        return out.index_add_(0, pg.e_i, vals_i).index_add_(0, pg.e_j, vals_j)

    def mv(A, x):
        """Batched matrix-vector product A x: (..., m, n), (..., n)."""
        return (A @ x[..., None])[..., 0]

    def chi2_of(T_all):
        r = _edge_residuals(zeros12, T_all[pg.e_i], T_all[pg.e_j], Tij_inv, pg.e_weight)
        return ps(torch.sum(r * r))[0]

    T_cur = T0
    lam = T0.new_tensor(1e-4)
    for _ in range(n_iters):
        T_i, T_j = T_cur[pg.e_i], T_cur[pg.e_j]
        r = _edge_residuals(zeros12, T_i, T_j, Tij_inv, pg.e_weight)
        J = _edge_jacobians(zeros12, T_i, T_j, Tij_inv, pg.e_weight)  # (E, 6, 12)
        Ji, Jj = J[:, :, :6], J[:, :, 6:]
        JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
        # The cost, the gradient and the per-pose diagonal blocks (damping
        # and preconditioning).
        chi2_cur, g, Hkk = ps(torch.sum(r * r), scatter(mv(JiT, r), mv(JjT, r)), scatter(JiT @ Ji, JjT @ Jj))
        g = g * freem
        dscale = torch.clamp(torch.amax(torch.diagonal(Hkk, dim1=1, dim2=2), dim=-1), min=1e-6)
        Hkk_d = Hkk + (lam * dscale)[:, None, None] * eye6
        Hkk_d = torch.where(pg.free[:, None, None], Hkk_d, eye6)
        M = torch.linalg.inv_ex(Hkk_d)[0]
        damp = (lam * dscale)[:, None] * freem

        def H_matvec(v):
            v = v * freem
            Jv = mv(Ji, v[pg.e_i]) + mv(Jj, v[pg.e_j])
            return (ps(scatter(mv(JiT, Jv), mv(JjT, Jv)))[0] + damp * v) * freem

        rhs = -g
        x = torch.zeros_like(rhs)
        res = rhs - H_matvec(x)
        z = mv(M, res)
        p = z
        rz = torch.sum(res * z)
        tol2 = 1e-12 * torch.clamp(torch.sum(rhs * rhs), min=1e-20)
        for _ in range(cg_iters):
            live = torch.sum(res * res) > tol2
            Hp = H_matvec(p)
            alpha = rz / torch.clamp(torch.sum(p * Hp), min=1e-20)
            x_n = x + alpha * p
            r_n = res - alpha * Hp
            z_n = mv(M, r_n)
            rz_n = torch.sum(r_n * z_n)
            beta = rz_n / torch.clamp(rz, min=1e-20)
            p_n = z_n + beta * p
            x = torch.where(live, x_n, x)
            res = torch.where(live, r_n, res)
            p = torch.where(live, p_n, p)
            rz = torch.where(live, rz_n, rz)
        dx = x * freem
        T_new = se3.exp_se3(dx) @ T_cur
        better = (chi2_of(T_new) < chi2_cur) & torch.isfinite(T_new).all()
        T_cur = torch.where(better, T_new, T_cur)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-8), torch.clamp(lam * 4.0, max=1e4))
    return T_cur
