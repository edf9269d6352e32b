"""Vectorized RANSAC: rigid 3D-3D alignment (Horn/Kabsch).

Port of `hfvo_tpu.solve.ransac` (reference: src/PnPsolver.cc EPnP RANSAC
:165 used by relocalization; src/Sim3Solver.cc:140 Horn similarity
RANSAC): all H minimal sets are sampled up front, solved at once (batched
Kabsch on the (H, 3, 3) cross-covariances), every point is scored against
every hypothesis in one broadcast and the best is refit on its inliers.

The JAX package draws the sample indices from a threefry stream, which no
port can reproduce. So the solver is split in two: a core that takes the
sample indices (`ransac_rigid_3d3d_core`, held to the JAX package's on the
JAX draw), and a wrapper that draws them on the caller's device with
`torch.multinomial` from a generator seeded with the JAX package's integer
seed (`draw_samples`). Every function takes leading batch dims.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..ops.batch import take_rows

N_HYPOTHESES = 128


class RansacResult(NamedTuple):
    T_ab: torch.Tensor  # (*B, 4, 4) best rigid transform mapping b-points to a-points
    inliers: torch.Tensor  # (*B, N) bool
    n_inliers: torch.Tensor  # (*B,) int64
    ok: torch.Tensor  # (*B,) bool


def _centred_svd(Xa, Xb, w):
    """Weighted centroids and the SVD of the cross-covariance B^T W A."""
    sw = torch.sum(w, dim=-1, keepdim=True) + 1e-9
    ca = torch.sum(Xa * w[..., None], dim=-2) / sw
    cb = torch.sum(Xb * w[..., None], dim=-2) / sw
    A = Xa - ca[..., None, :]
    B = Xb - cb[..., None, :]
    H = torch.einsum("...ni,...n,...nj->...ij", B, w, A)
    U, _, Vt = torch.linalg.svd(H)
    # Reflection fix: R = V diag(1, 1, det(V U^T)) U^T.
    det = torch.linalg.det(Vt.transpose(-1, -2) @ U.transpose(-1, -2))
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    R = torch.einsum("...ji,...j,...kj->...ik", Vt, D, U)
    return ca, cb, A, B, R


def kabsch(Xa: torch.Tensor, Xb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted rigid transform T with Xa ~ T @ Xb. Shapes (*B, N, 3), w (*B, N)."""
    ca, cb, _, _, R = _centred_svd(Xa, Xb, w)
    t = ca - torch.einsum("...ij,...j->...i", R, cb)
    return se3.rt_to_mat(R, t)


def kabsch_sim3(Xa: torch.Tensor, Xb: torch.Tensor, w: torch.Tensor):
    """Weighted Horn similarity (s, T) with Xa ~ s R Xb + t (reference:
    Sim3Solver::ComputeSim3, src/Sim3Solver.cc:226); the scale is the
    symmetric sqrt(sum w|A|^2 / sum w|B|^2)."""
    ca, cb, A, B, R = _centred_svd(Xa, Xb, w)
    na = torch.sum(w[..., None] * A * A, dim=(-2, -1))
    nb = torch.sum(w[..., None] * B * B, dim=(-2, -1))
    s = torch.sqrt(na / torch.clamp(nb, min=1e-12))
    t = ca - s[..., None] * torch.einsum("...ij,...j->...i", R, cb)
    return s, se3.rt_to_mat(R, t)


def draw_samples(valid: torch.Tensor, n_hyp: int, k: int, seed: int) -> torch.Tensor:
    """(*B, n_hyp, k) int64 sample indices into the last axis of `valid`
    (*B, N), drawn with replacement with probability proportional to
    `valid`, on `valid`'s device, from a generator seeded with `seed` for
    each batch element (so an element draws what it would draw alone). A
    row with no valid entry draws uniformly instead (`torch.multinomial`
    refuses an all-zero row); its hypotheses then score no inlier."""
    N = valid.shape[-1]
    p = valid.reshape(-1, N).float()
    p = torch.where(torch.sum(p, dim=-1, keepdim=True) > 0, p, torch.ones_like(p))
    g = torch.Generator(device=valid.device)
    rows = []
    for row in p:
        g.manual_seed(int(seed))
        rows.append(torch.multinomial(row, n_hyp * k, replacement=True, generator=g))
    return torch.stack(rows).reshape(valid.shape[:-1] + (n_hyp, k))


def ransac_rigid_3d3d_core(
    Xa: torch.Tensor,  # (*B, N, 3) target points (e.g. map / world)
    Xb: torch.Tensor,  # (*B, N, 3) source points (e.g. current camera frame)
    valid: torch.Tensor,  # (*B, N) bool
    idx: torch.Tensor,  # (*B, H, 3) sample indices
    inlier_th: float = 0.05,
    min_inliers: int = 12,
) -> RansacResult:
    """Best rigid T with Xa ~ T Xb from the given 3-point hypotheses, refit
    on the winner's inliers (hfvo_tpu/solve/ransac.py:75-112)."""
    flat = idx.reshape(idx.shape[:-2] + (-1,))
    A = take_rows(Xa, flat).reshape(idx.shape + (3,))  # (*B, H, 3, 3)
    B = take_rows(Xb, flat).reshape(idx.shape + (3,))
    T_h = kabsch(A, B, torch.ones(idx.shape, dtype=Xa.dtype, device=Xa.device))
    # Degenerate sample guard: nearly collinear triples give an unstable R.
    spread = torch.linalg.norm(
        torch.linalg.cross(A[..., 1, :] - A[..., 0, :], A[..., 2, :] - A[..., 0, :], dim=-1), dim=-1)
    ok_h = spread > 1e-4
    Xb_h = torch.einsum("...hij,...nj->...hni", T_h[..., :3, :3], Xb) + T_h[..., :, None, :3, 3]
    err = torch.linalg.norm(Xb_h - Xa[..., None, :, :], dim=-1)  # (*B, H, N)
    inl = (err < inlier_th) & valid[..., None, :]
    counts = torch.sum(inl, dim=-1) * ok_h
    best = torch.argmax(counts, dim=-1)  # the first maximum, as jnp.argmax
    best_inl = take_rows(inl, best[..., None])[..., 0, :]

    T_fit = kabsch(Xa, Xb, best_inl.to(Xa.dtype))
    err_f = torch.linalg.norm(se3.transform(T_fit[..., None, :, :], Xb) - Xa, dim=-1)
    final = (err_f < inlier_th) & valid
    n = torch.sum(final, dim=-1)
    return RansacResult(T_fit, final, n, n >= min_inliers)


def ransac_rigid_3d3d(
    Xa: torch.Tensor,
    Xb: torch.Tensor,
    valid: torch.Tensor,
    seed: int,
    inlier_th: float = 0.05,
    min_inliers: int = 12,
) -> RansacResult:
    """`ransac_rigid_3d3d_core` on N_HYPOTHESES triples drawn by
    `draw_samples` with `seed` (the JAX package's `PRNGKey(seed)`)."""
    idx = draw_samples(valid, N_HYPOTHESES, 3, seed)
    return ransac_rigid_3d3d_core(Xa, Xb, valid, idx, inlier_th, min_inliers)
