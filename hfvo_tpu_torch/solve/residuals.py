"""Point and stereo residuals + analytic Jacobians for the pose LM.

Port of the point terms of `hfvo_tpu.solve.residuals`: `r` and `J` w.r.t.
a left-multiplied se(3) twist on `T_cw` (`T <- exp([rho, w]) @ T`), twist
order [rho (trans), w (rot)]. Line, plane and direction edges come with
their slices.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..geometry import se3
from ..geometry.camera import Intrinsics


def _inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))


def transform_jacobian(X_c: torch.Tensor) -> torch.Tensor:
    """d X_c / d twist for left-perturbation: (..., 3, 6) = [I | -hat(X_c)]."""
    eye = torch.eye(3, dtype=X_c.dtype, device=X_c.device).expand(X_c.shape[:-1] + (3, 3))
    return torch.cat([eye, -se3.hat(X_c)], dim=-1)


def proj_jacobian(intr: Intrinsics, X_c: torch.Tensor) -> torch.Tensor:
    """d(u, v) / d X_c: (..., 2, 3)."""
    x, y, z = X_c[..., 0], X_c[..., 1], X_c[..., 2]
    iz = _inv_z(z)
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row_u = torch.stack([intr.fx * iz, zero, -intr.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, intr.fy * iz, -intr.fy * y * iz2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def point_stereo_residual(
    T_cw: torch.Tensor,
    X_w: torch.Tensor,
    obs_uvr: torch.Tensor,
    intr: Intrinsics,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stereo (u, v, u_r) reprojection residual for N points under one pose
    (g2o `EdgeStereoSE3ProjectXYZOnlyPose`, src/Optimizer.cc:590-1478).

    Returns (r (N, 3), J (N, 3, 6), z (N,) camera depth)."""
    X_c = se3.transform(T_cw, X_w)
    x, y, z = X_c[..., 0], X_c[..., 1], X_c[..., 2]
    iz = _inv_z(z)
    u = intr.fx * x * iz + intr.cx
    v = intr.fy * y * iz + intr.cy
    ur = u - intr.bf * iz
    r = torch.stack([u, v, ur], dim=-1) - obs_uvr
    Juv = proj_jacobian(intr, X_c)
    zero = torch.zeros_like(z)
    dur = Juv[..., 0, :] + torch.stack([zero, zero, intr.bf * iz * iz], dim=-1)
    Jproj = torch.cat([Juv, dur[..., None, :]], dim=-2)  # (N, 3, 3)
    return r, Jproj @ transform_jacobian(X_c), z


def _cross_rows(X_c, a0, a1, a2):
    """Components of X_c x a (the rotation block of a projected row)."""
    x, y, z = X_c[..., 0], X_c[..., 1], X_c[..., 2]
    return (y * a2 - z * a1, z * a0 - x * a2, x * a1 - y * a0)


def point_stereo_terms_t(
    T_cw: torch.Tensor,
    X_w: torch.Tensor,
    obs_uvr: torch.Tensor,
    intr: Intrinsics,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Edge-axis-last stereo point terms: (r (3, N), Jt (3, 6, N), z (N)).

    The same math as `point_stereo_residual`: row k of J is
    [a_k | X_c x a_k] for a_k = d r_k / d X_c."""
    X_c = se3.transform(T_cw, X_w)
    x, y, z = X_c[..., 0], X_c[..., 1], X_c[..., 2]
    iz = _inv_z(z)
    iz2 = iz * iz
    u = intr.fx * x * iz + intr.cx
    v = intr.fy * y * iz + intr.cy
    ur = u - intr.bf * iz
    r = torch.stack(
        [u - obs_uvr[..., 0], v - obs_uvr[..., 1], ur - obs_uvr[..., 2]], dim=0
    )
    zero = torch.zeros_like(x)
    rows = []
    for a0, a1, a2 in (
        (intr.fx * iz, zero, -intr.fx * x * iz2),
        (zero, intr.fy * iz, -intr.fy * y * iz2),
        (intr.fx * iz, zero, (intr.bf - intr.fx * x) * iz2),
    ):
        c0, c1, c2 = _cross_rows(X_c, a0, a1, a2)
        rows.append(torch.stack([a0, a1, a2, c0, c1, c2], dim=0))
    return r, torch.stack(rows, dim=0), z
