"""Pinhole camera model: projection, unprojection, radial-tangential distortion.

Port of `hfvo_tpu.geometry.camera`. `Intrinsics` stays a NamedTuple of
floats (hashable, so configs stay frozen); the functions take torch tensors
and broadcast over leading dims.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Intrinsics(NamedTuple):
    """fx, fy, cx, cy plus radtan distortion (k1, k2, p1, p2, k3) and stereo bf.

    `bf` = baseline * fx, used for the virtual-right-image coordinate
    `u_r = u - bf / depth` that the reference derives from RGB-D depth
    (reference: src/Frame.cc:1940-1960 `ComputeStereoFromRGBD`).
    """

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 40.0
    width: int = 640
    height: int = 480

    @property
    def K(self) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
        )

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))


def project(intr: Intrinsics, X_c: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixel coords (..., 2). No distortion."""
    inv_z = 1.0 / _safe_z(X_c[..., 2])
    u = intr.fx * X_c[..., 0] * inv_z + intr.cx
    v = intr.fy * X_c[..., 1] * inv_z + intr.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(intr: Intrinsics, X_c: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3) of (u, v, u_r) with u_r = u - bf/z."""
    uv = project(intr, X_c)
    ur = uv[..., 0] - intr.bf / _safe_z(X_c[..., 2])
    return torch.cat([uv, ur[..., None]], dim=-1)


def unproject(intr: Intrinsics, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) + depth (...,) -> camera-frame points (..., 3)
    (reference: `UnprojectStereo`, src/Frame.cc:2088-2103)."""
    x = (uv[..., 0] - intr.cx) / intr.fx * depth
    y = (uv[..., 1] - intr.cy) / intr.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def distort_normalized(intr: Intrinsics, xy: torch.Tensor) -> torch.Tensor:
    """Apply radtan distortion to normalized coords (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (intr.k1 + r2 * (intr.k2 + r2 * intr.k3))
    xd = x * radial + 2.0 * intr.p1 * x * y + intr.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + intr.p1 * (r2 + 2.0 * y * y) + 2.0 * intr.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(intr: Intrinsics, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Undistort pixel coords by fixed-point iteration (cv::undistortPoints
    equivalent)."""
    f = torch.tensor([intr.fx, intr.fy], dtype=uv.dtype, device=uv.device)
    c = torch.tensor([intr.cx, intr.cy], dtype=uv.dtype, device=uv.device)
    xy_d = (uv - c) / f
    xy = xy_d
    for _ in range(iters):
        xy = xy_d - (distort_normalized(intr, xy) - xy)
    return xy * f + c


def in_image(intr: Intrinsics, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Boolean mask (...,) of pixels inside the image bounds."""
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < intr.width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < intr.height - margin)
    )
