"""Distributed pose optimization: an edge-sharded normal-equation reduction.

Port of `hfvo_tpu.parallel.dist_lm` on `torch.distributed`. The edges
(landmark observations) are split over the mesh's `edge` ranks: each rank
builds partial H = sum J^T W J, b = sum J^T W r and chi2 over its block, one
all-reduce over the `edge` group sums them, and every rank solves the same
6x6 system and applies the same update. Independent sequences ride the
`seq` axis: each `seq` row of ranks solves its block of the sequences, and
the poses are gathered over `seq` at the end (no other cross-sequence
communication).
"""
from __future__ import annotations

import torch

from ..geometry import se3
from ..geometry.camera import Intrinsics
from ..solve import residuals
from .mesh import Mesh


def _partial_normal_eqs(T, X_w, obs, w, intr):
    """This rank's H (S, 6, 6), b (S, 6) and chi2 (S,) of its edge block;
    edge-axis-last Jacobians (S, 3, 6, N) as the JAX package's."""
    r, Jt, z = residuals.point_stereo_terms_t(T, X_w, obs, intr)
    w = torch.where(z > 1e-3, w, torch.zeros_like(w))
    H = torch.einsum("skin,sn,skjn->sij", Jt, w, Jt)
    b = torch.einsum("skin,skn->si", Jt, w[:, None] * r)
    chi2 = torch.sum(w * torch.sum(r * r, dim=1), dim=-1)
    return H, b, chi2


def dist_pose_step(
    mesh: Mesh,
    T_cw: torch.Tensor,  # (S, 4, 4) one pose per sequence, replicated
    X_w: torch.Tensor,  # (S, E, 3) edges, E split over 'edge'
    obs: torch.Tensor,  # (S, E, 3)
    weight: torch.Tensor,  # (S, E) 0 = invalid edge
    intr: Intrinsics,
    n_iters: int = 5,
) -> torch.Tensor:
    """The distributed Gauss-Newton/LM run of hfvo_tpu/parallel/dist_lm.py:
    41-81 from the same replicated inputs on every rank; returns the updated
    (S, 4, 4) poses, replicated. S splits over 'seq' and E over 'edge'."""
    seq = mesh.block_range(T_cw.shape[0], "seq")
    edge = mesh.block_range(X_w.shape[1], "edge")
    T = T_cw[seq]
    X, o, w = X_w[seq, edge], obs[seq, edge], weight[seq, edge]
    lam = torch.full((T.shape[0],), 1e-3, dtype=T.dtype, device=T.device)
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
    for _ in range(n_iters):
        H, b, chi2 = _partial_normal_eqs(T, X, o, w, intr)
        H, b, chi2 = mesh.psum_all(H, b, chi2)
        Hd = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=1, dim2=2)) + 1e-8 * eye6
        delta = -torch.linalg.solve_ex(Hd, b[..., None]).result[..., 0]
        T_new = se3.exp_se3(delta) @ T
        chi2_new = mesh.psum(_partial_normal_eqs(T_new, X, o, w, intr)[2])
        accept = (chi2_new < chi2) & torch.isfinite(T_new).all(dim=(1, 2))
        T = torch.where(accept[:, None, None], T_new, T)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
    return mesh.all_gather(T, "seq")
