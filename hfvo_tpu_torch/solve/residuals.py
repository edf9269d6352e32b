"""Point, stereo, line-endpoint and line-direction residuals + analytic
Jacobians for the pose LM.

Port of those terms of `hfvo_tpu.solve.residuals`: `r` and `J` w.r.t. a
left-multiplied se(3) twist on `T_cw` (`T <- exp([rho, w]) @ T`), twist
order [rho (trans), w (rot)]. Plane edges and the metric 3D term come with
their slices. The edge-axis-last `*_terms_t` functions also take a leading
sequence axis: T_cw (*B, 4, 4) against edges (*B, N, ...).
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
    """Edge-axis-last stereo point terms: (r (*B, 3, N), Jt (*B, 3, 6, N),
    z (*B, N)).

    The same math as `point_stereo_residual`: row k of J is
    [a_k | X_c x a_k] for a_k = d r_k / d X_c."""
    X_c = se3.transform(T_cw[..., None, :, :], X_w)
    x, y, z = X_c[..., 0], X_c[..., 1], X_c[..., 2]
    iz = _inv_z(z)
    iz2 = iz * iz
    u = intr.fx * x * iz + intr.cx
    v = intr.fy * y * iz + intr.cy
    ur = u - intr.bf * iz
    r = torch.stack(
        [u - obs_uvr[..., 0], v - obs_uvr[..., 1], ur - obs_uvr[..., 2]], dim=-2
    )
    zero = torch.zeros_like(x)
    rows = []
    for a0, a1, a2 in (
        (intr.fx * iz, zero, -intr.fx * x * iz2),
        (zero, intr.fy * iz, -intr.fy * y * iz2),
        (intr.fx * iz, zero, (intr.bf - intr.fx * x) * iz2),
    ):
        c0, c1, c2 = _cross_rows(X_c, a0, a1, a2)
        rows.append(torch.stack([a0, a1, a2, c0, c1, c2], dim=-2))
    return r, torch.stack(rows, dim=-3), z


def line_endpoint_residual(
    T_cw: torch.Tensor,
    X_w: torch.Tensor,
    line_2d: torch.Tensor,
    intr: Intrinsics,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Point-to-infinite-2D-line distance of projected 3D line endpoints,
    `l . proj(T X)` for the normalized observed line l = (a, b, c)
    (include/EdgeLine.h:53 `EdgeLineProjectXYZ`).

    Returns (r (N, 1), J (N, 1, 6), z (N,))."""
    X_c = se3.transform(T_cw, X_w)
    z = X_c[..., 2]
    iz = _inv_z(z)
    u = intr.fx * X_c[..., 0] * iz + intr.cx
    v = intr.fy * X_c[..., 1] * iz + intr.cy
    a, b, c = line_2d[..., 0], line_2d[..., 1], line_2d[..., 2]
    r = (a * u + b * v + c)[..., None]
    Juv = proj_jacobian(intr, X_c)
    dl = a[..., None] * Juv[..., 0, :] + b[..., None] * Juv[..., 1, :]
    return r, dl[..., None, :] @ transform_jacobian(X_c), z


def line_terms_t(
    T_cw: torch.Tensor,
    X_w: torch.Tensor,
    line_2d: torch.Tensor,
    intr: Intrinsics,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Edge-axis-last line-endpoint terms: (r (*B, N), Jt (*B, 6, N),
    z (*B, N))."""
    X_c = se3.transform(T_cw[..., None, :, :], X_w)
    x, y, z = X_c[..., 0], X_c[..., 1], X_c[..., 2]
    iz = _inv_z(z)
    iz2 = iz * iz
    u = intr.fx * x * iz + intr.cx
    v = intr.fy * y * iz + intr.cy
    a, b, c = line_2d[..., 0], line_2d[..., 1], line_2d[..., 2]
    r = a * u + b * v + c
    dl0 = a * intr.fx * iz
    dl1 = b * intr.fy * iz
    dl2 = -(a * intr.fx * x + b * intr.fy * y) * iz2
    c0, c1, c2 = _cross_rows(X_c, dl0, dl1, dl2)
    return r, torch.stack([dl0, dl1, dl2, c0, c1, c2], dim=-2), z


def dir_terms_t(
    T_cw: torch.Tensor, d_w: torch.Tensor, d_c_in: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-axis-last direction-chord terms R d_w - d_c with the observed
    direction's sign folded onto the prediction's (line directions are
    sign-ambiguous): (r (*B, 3, V), Jt (*B, 3, 6, V)); rotation block
    -hat(v) rowwise, translation block zero."""
    v = d_w @ T_cw[..., :3, :3].transpose(-1, -2)
    s = torch.sign(torch.sum(v * d_c_in, dim=-1, keepdim=True))
    d_c = d_c_in * torch.where(s == 0, torch.ones_like(s), s)
    r = (v - d_c).transpose(-1, -2)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    Jt = torch.stack(
        [
            torch.stack([zero, zero, zero, zero, z, -y], dim=-2),
            torch.stack([zero, zero, zero, -z, zero, x], dim=-2),
            torch.stack([zero, zero, zero, y, -x, zero], dim=-2),
        ],
        dim=-3,
    )
    return r, Jt
