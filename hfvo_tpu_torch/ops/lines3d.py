"""3D line fitting from depth samples along 2D segments.

Port of `hfvo_tpu.ops.lines3d` (reference: `Frame::isLineGood` +
`LINEextractor::extract3dline_mahdist`, src/Frame.cc:1205-1322,
src/LineExtractor.cpp): sample S depth points along each segment, score a
fixed table of RANSAC hypotheses (index pairs) with a depth-noise-scaled
distance gate, refit the best hypothesis' inliers by weighted PCA, and trim
the endpoints to the supported extent. All lines fit at once, and with a
leading sequence axis all lines of S frames.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.camera import Intrinsics
from . import sym_eig
from .batch import gather_pixels

S_SAMPLES = 20  # depth samples per segment (reference: Frame.cc:1211)
N_HYP = 24  # RANSAC hypotheses per line

# Fixed hypothesis index pairs spread across the sample range, built with
# the JAX package's recipe (hfvo_tpu/ops/lines3d.py:28-37).
_rs = np.random.RandomState(7)
_PAIRS = np.stack(
    [
        np.concatenate([np.arange(0, S_SAMPLES // 2), _rs.randint(0, S_SAMPLES, N_HYP - S_SAMPLES // 2)]),
        np.concatenate([np.arange(S_SAMPLES // 2, S_SAMPLES), _rs.randint(0, S_SAMPLES, N_HYP - S_SAMPLES // 2)]),
    ],
    axis=1,
).astype(np.int32)  # (N_HYP, 2)
_PAIRS[:, 1] = np.where(_PAIRS[:, 0] == _PAIRS[:, 1], (_PAIRS[:, 1] + 7) % S_SAMPLES, _PAIRS[:, 1])
del _rs


def depth_sigma(d: torch.Tensor) -> torch.Tensor:
    """Axial depth noise model (Kinect-like quadratic; reference:
    src/LineExtractor.cpp:31-42 c1*d^2 + c2*d + c3)."""
    return 0.0012 + 0.0019 * (d - 0.4) ** 2


class Lines3D(NamedTuple):
    X0_c: torch.Tensor  # (M, 3) camera-frame endpoint
    X1_c: torch.Tensor  # (M, 3)
    valid: torch.Tensor  # (M,) 3D fit succeeded


def fit_lines_3d(
    depth_img: torch.Tensor,
    intr: Intrinsics,
    p0: torch.Tensor,  # (M, 2)
    p1: torch.Tensor,  # (M, 2)
    valid2d: torch.Tensor,  # (M,)
    min_valid: int = 5,
    min_length: float = 0.02,
) -> Lines3D:
    """depth_img (*B, H, W), segments (*B, M, 2) -> Lines3D with (*B, M)
    leading dims."""
    h, w = depth_img.shape[-2:]
    dev = p0.device
    ts = (torch.arange(S_SAMPLES, device=dev).float() + 0.5) / S_SAMPLES
    pts = p0[..., None, :] + (p1 - p0)[..., None, :] * ts[:, None]  # (*B, M, S, 2)
    xi = torch.clamp(torch.round(pts[..., 0]).long(), 0, w - 1)
    yi = torch.clamp(torch.round(pts[..., 1]).long(), 0, h - 1)
    d = gather_pixels(depth_img, yi, xi)  # (*B, M, S)
    has_d = d > 1e-3
    X = torch.stack(
        [
            (pts[..., 0] - intr.cx) / intr.fx * d,
            (pts[..., 1] - intr.cy) / intr.fy * d,
            d,
        ],
        dim=-1,
    )  # (*B, M, S, 3)
    sigma = depth_sigma(d)

    pa = torch.from_numpy(_PAIRS[:, 0]).long().to(dev)
    pb = torch.from_numpy(_PAIRS[:, 1]).long().to(dev)
    A = X[..., pa, :]  # (*B, M, H, 3)
    B = X[..., pb, :]
    dir_h = B - A
    dir_h = dir_h / (torch.linalg.norm(dir_h, dim=-1, keepdim=True) + 1e-9)
    hyp_ok = has_d[..., pa] & has_d[..., pb]

    # Distance of every sample to every hypothesis line.
    rel = X[..., None, :, :] - A[..., :, None, :]  # (*B, M, H, S, 3)
    cross = torch.linalg.cross(rel, dir_h[..., :, None, :].expand_as(rel), dim=-1)
    dist = torch.linalg.norm(cross, dim=-1)  # (*B, M, H, S)
    gate = 3.0 * sigma[..., None, :] + 0.003
    inl = (dist < gate) & has_d[..., None, :] & hyp_ok[..., :, None]
    counts = torch.sum(inl, dim=-1)  # (*B, M, H)
    best = torch.argmax(counts, dim=-1)  # (*B, M) first maximum
    best_inl = torch.gather(
        inl, -2, best[..., None, None].expand(best.shape + (1, inl.shape[-1])))[..., 0, :]

    # Weighted PCA refit over the best hypothesis' inliers.
    wgt = torch.where(best_inl, 1.0 / (sigma**2 + 1e-9), torch.zeros_like(sigma))
    sw = torch.sum(wgt, dim=-1, keepdim=True) + 1e-9
    # The centroid is taken relative to the first inlier sample, so that a
    # line whose inlier samples all have one depth gets exactly 0 in Xc's
    # depth column, whatever the sum order.
    first = torch.argmax(best_inl.to(torch.int8), dim=-1)
    X_ref = torch.gather(X, -2, first[..., None, None].expand(first.shape + (1, 3)))  # (*B, M, 1, 3)
    c = X_ref[..., 0, :] + torch.sum(wgt[..., None] * (X - X_ref), dim=-2) / sw  # (*B, M, 3)
    Xc = X - c[..., None, :]
    cov = torch.einsum("...msi,...ms,...msj->...mij", Xc, wgt, Xc) / sw[..., None]
    # Principal direction from the symmetric 3x3 eigendecomposition.
    _, evecs = sym_eig.eigh3(cov + 1e-12 * torch.eye(3, device=dev))
    u = evecs[..., -1]  # (M, 3) largest-eigenvalue direction
    # On such a constant-depth line (a wall facing the camera) the
    # covariance's depth row is exactly zero and the eigenvector's sign,
    # which decides which end is X0, is rounding noise of the Jacobi sweeps:
    # the JAX package's own choice there changes between its jitted and
    # op-by-op runs. The port orients these lines along their 2D segment
    # (X0 at the p0 end), the same on every device. Elsewhere the sign is
    # the JAX package's (ROADMAP queue 3).
    flat = torch.all(~best_inl | (X[..., 2] == X_ref[..., 2]), dim=-1)
    d2 = p1 - p0
    along_2d = u[..., 0] * intr.fx * d2[..., 0] + u[..., 1] * intr.fy * d2[..., 1]
    u = torch.where((flat & (along_2d < 0))[..., None], -u, u)

    along = torch.einsum("...msi,...mi->...ms", Xc, u)
    big = torch.tensor(1e9, device=dev)
    a_min = torch.min(torch.where(best_inl, along, big), dim=-1).values
    a_max = torch.max(torch.where(best_inl, along, -big), dim=-1).values
    X0 = c + u * a_min[..., None]
    X1 = c + u * a_max[..., None]

    n_inl = torch.sum(best_inl, dim=-1)
    n_valid_d = torch.sum(has_d, dim=-1)
    ok = (
        valid2d
        & (n_valid_d >= min_valid)
        & (n_inl >= min_valid)
        & (n_inl >= torch.div(n_valid_d * 6, 10, rounding_mode="floor"))  # verify3dLine-style ratio
        & (a_max - a_min >= min_length)
        & torch.isfinite(X0).all(dim=-1)
        & torch.isfinite(X1).all(dim=-1)
    )
    return Lines3D(X0, X1, ok)
