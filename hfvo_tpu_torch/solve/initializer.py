"""Monocular two-view initialization: parallel H/F scoring + reconstruction.

Port of `hfvo_tpu.solve.initializer` (reference: src/Initializer.cc:111-125
— homography and fundamental hypotheses scored in parallel threads, model
chosen by the ORB-SLAM2 ratio rule). The RGB-D pipeline never calls it
(depth initializes directly, src/Tracking.cc:1350); it is ported so that
the port does all the JAX package does. All minimal-set hypotheses of both
models solve and score at once; model selection uses RH = S_H / (S_H + S_F)
> 0.45; reconstruction recovers (R, t) from the essential matrix with a
cheirality test over the triangulated inliers.

As the RANSACs of `solve/ransac.py`, the solver is split in two: a core
that takes the (128, 8) sample indices, and a wrapper that draws them with
`solve.ransac.draw_samples` from a generator seeded with the integer seed
(the JAX package draws from `PRNGKey(seed)`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.camera import Intrinsics
from .ransac import draw_samples

N_HYP = 128
TH_F = 3.84  # chi2 gates (ORB-SLAM2 scoring, reference Initializer.cc)
TH_H = 5.99
TH_SCORE = 5.99


class InitResult(NamedTuple):
    ok: torch.Tensor  # () bool
    used_H: torch.Tensor  # () bool — homography model selected
    T_21: torch.Tensor  # (4, 4) pose of view 2 w.r.t. view 1 (unit-norm t)
    X_1: torch.Tensor  # (N, 3) triangulated points in view-1 frame
    inliers: torch.Tensor  # (N,)
    score_h: torch.Tensor
    score_f: torch.Tensor


def _normalize(uv, intr):
    f = uv.new_tensor([intr.fx, intr.fy])
    c = uv.new_tensor([intr.cx, intr.cy])
    return (uv - c) / f


def _null_vector(A):
    """The eigenvector of A^T A with the smallest eigenvalue (..., 9)."""
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return V[..., :, 0]


def _dlt_F(x1, x2):
    """8-point fundamental (normalized coords): (H, 8, 2) x2 -> (H, 3, 3) rank-2."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1
    )
    F = _null_vector(A).reshape(A.shape[:-2] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)
    S = S * S.new_tensor([1.0, 1.0, 0.0])
    return (U * S[..., None, :]) @ Vt


def _dlt_H(x1, x2):
    """4-point homography: (H, 4, 2) x2 -> (H, 3, 3)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    r2 = torch.stack([z, z, z, u1, v1, o, -v2 * u1, -v2 * v1, -v2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (H, 8, 9)
    return _null_vector(A).reshape(A.shape[:-2] + (3, 3))


def _score(d1, d2, th, valid):
    in1 = (d1 < th * 1e-5) & valid
    in2 = (d2 < th * 1e-5) & valid
    score = torch.sum(torch.where(in1, TH_SCORE * 1e-5 - d1, 0.0), dim=-1) + torch.sum(
        torch.where(in2, TH_SCORE * 1e-5 - d2, 0.0), dim=-1
    )
    return score, in1 & in2


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _score_F(F, x1, x2, valid):
    """Symmetric epipolar chi2 score of each hypothesis (reference
    CheckFundamental): F (H, 3, 3) -> scores (H,), inliers (H, N)."""
    x1h, x2h = _homog(x1), _homog(x2)
    l2 = x1h @ F.transpose(-1, -2)  # epipolar lines in image 2
    l1 = x2h @ F
    d2 = torch.sum(x2h * l2, dim=-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    d1 = torch.sum(x1h * l1, dim=-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    return _score(d1, d2, TH_F, valid)


def _score_H(H, x1, x2, valid):
    """Symmetric transfer chi2 score of each hypothesis (reference
    CheckHomography)."""
    x1h, x2h = _homog(x1), _homog(x2)
    Hx1 = x1h @ H.transpose(-1, -2)
    Hx1 = Hx1[..., :2] / (Hx1[..., 2:3] + 1e-12)
    Hinv = torch.linalg.inv(H + 1e-12 * torch.eye(3, device=H.device))
    Hx2 = x2h @ Hinv.transpose(-1, -2)
    Hx2 = Hx2[..., :2] / (Hx2[..., 2:3] + 1e-12)
    d2 = torch.sum((x2 - Hx1) ** 2, dim=-1)
    d1 = torch.sum((x1 - Hx2) ** 2, dim=-1)
    return _score(d1, d2, TH_H, valid)


def _triangulate(T_21, x1, x2):
    """DLT triangulation in the view-1 frame, normalized coords: (N, 3)."""
    P1 = torch.eye(4, device=x1.device)[:3]
    P2 = T_21[:3]
    A = torch.stack([
        x1[:, 0:1] * P1[2] - P1[0],
        x1[:, 1:2] * P1[2] - P1[1],
        x2[:, 0:1] * P2[2] - P2[0],
        x2[:, 1:2] * P2[2] - P2[1],
    ], dim=1)  # (N, 4, 4)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    X = V[..., :, 0]
    w = X[:, 3:4]
    return X[:, :3] / torch.where(torch.abs(w) > 1e-12, w, torch.full_like(w, 1e-12))


def initialize_two_view_core(
    intr: Intrinsics,
    uv1: torch.Tensor,  # (N, 2) matched pixels in view 1
    uv2: torch.Tensor,  # (N, 2)
    valid: torch.Tensor,  # (N,) bool
    idx8: torch.Tensor,  # (N_HYP, 8) sample indices
) -> InitResult:
    x1 = _normalize(uv1, intr)
    x2 = _normalize(uv2, intr)
    Fs = _dlt_F(x1[idx8], x2[idx8])
    Hs = _dlt_H(x1[idx8[:, :4]], x2[idx8[:, :4]])
    return select_and_reconstruct(x1, x2, valid, Fs, Hs)


def select_and_reconstruct(x1, x2, valid, Fs, Hs) -> InitResult:
    """Score the hypotheses Fs and Hs (H, 3, 3) on the normalized matches
    x1, x2 (N, 2), choose the model, and reconstruct from the best F. Each
    hypothesis is the null vector of an 8 x 9 system, which float32 resolves
    only to a few per cent in LAPACK and XLA alike; from here on, the same
    hypotheses give the same result."""
    sF, inF = _score_F(Fs, x1, x2, valid)
    bF = torch.argmax(sF)
    F = Fs[bF]
    score_f = sF[bF]

    sH, _ = _score_H(Hs, x1, x2, valid)
    score_h = sH[torch.argmax(sH)]

    used_H = score_h / torch.clamp(score_h + score_f, min=1e-12) > 0.45

    # Essential-matrix reconstruction (normalized coords: E = F).
    U, _, Vt = torch.linalg.svd(F)
    # Enforce det(R) = +1 sign conventions.
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = F.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    cands = torch.stack([
        se3.rt_to_mat(R1, t), se3.rt_to_mat(R1, -t),
        se3.rt_to_mat(R2, t), se3.rt_to_mat(R2, -t),
    ])
    inl_f = inF[bF]
    counts, Xs = [], []
    for T in cands:
        X = _triangulate(T, x1, x2)
        X2 = se3.transform(T, X)
        ok = (X[:, 2] > 0) & (X2[:, 2] > 0) & valid & inl_f
        counts.append(torch.sum(ok.to(torch.int64)))
        Xs.append(X)
    counts = torch.stack(counts)
    best = torch.argmax(counts)
    T_21 = cands[best]
    X_1 = torch.stack(Xs)[best]
    good = counts[best]
    inliers = inl_f & valid
    # ORB-SLAM2's minTriangulated=50 floor (reference uses the same gate).
    ok = (good > 0.7 * torch.clamp(torch.sum(inliers.to(torch.int64)), min=1)) & (good >= 50)
    return InitResult(ok, used_H, T_21, X_1, inliers, score_h, score_f)


def initialize_two_view(
    intr: Intrinsics,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    valid: torch.Tensor,
    seed: int,
) -> InitResult:
    """Two-view initialization with samples drawn from `seed` (the JAX
    package's `initialize_two_view(intr, uv1, uv2, valid, seed)`)."""
    idx8 = draw_samples(valid, N_HYP, 8, seed)
    return initialize_two_view_core(intr, uv1, uv2, valid, idx8)
