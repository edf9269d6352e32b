"""Point, stereo, line-endpoint, line-direction and plane residuals +
analytic Jacobians for the pose LM.

Port of `hfvo_tpu.solve.residuals`: `r` and `J` w.r.t. a left-multiplied
se(3) twist on `T_cw` (`T <- exp([rho, w]) @ T`), twist order [rho
(trans), w (rot)], with the metric 3D point term. The plane functions and the edge-axis-last `*_terms_t` functions also take a
leading sequence axis: T_cw (*B, 4, 4) against edges (*B, N, ...).
"""
from __future__ import annotations

import math
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


def point3d_terms_t(
    T_cw: torch.Tensor, X_w: torch.Tensor, X_c_obs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-axis-last metric 3D alignment terms T X_w - X_c_obs:
    (r (*B, 3, N), Jt (*B, 3, 6, N)); J = [I | -hat(X_c)] rowwise."""
    X_c = se3.transform(T_cw[..., None, :, :], X_w)
    x, y, z = X_c[..., 0], X_c[..., 1], X_c[..., 2]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r = (X_c - X_c_obs).transpose(-1, -2)
    Jt = torch.stack(
        [
            torch.stack([one, zero, zero, zero, z, -y], dim=-2),
            torch.stack([zero, one, zero, -z, zero, x], dim=-2),
            torch.stack([zero, zero, one, y, -x, zero], dim=-2),
        ],
        dim=-3,
    )
    return r, Jt


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


def plane_residual(T_cw: torch.Tensor, pi_w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A map plane pi_w = (n_w, d_w) (unit normal) in the camera frame,
    pi_c = T_cw^{-T} pi_w = (R n_w, d_w - t . R n_w), and its Jacobian
    (reference: g2oAddition/Plane3D.h:84-113). Returns (pi_c (*B, N, 4),
    J_pi (*B, N, 4, 6))."""
    R = T_cw[..., :3, :3]
    t = T_cw[..., :3, 3]
    n_c = pi_w[..., :3] @ R.transpose(-1, -2)
    d_c = pi_w[..., 3] - torch.sum(n_c * t[..., None, :], dim=-1)
    pi_c = torch.cat([n_c, d_c[..., None]], dim=-1)
    # Left perturbation: n_c' = (I + hat(w)) n_c -> dn/dw = -hat(n_c);
    # d_c' = d_c - rho . n_c.
    dn = torch.cat([torch.zeros(n_c.shape + (3,), dtype=n_c.dtype, device=n_c.device),
                    -se3.hat(n_c)], dim=-1)
    dd = torch.cat([-n_c, torch.zeros_like(n_c)], dim=-1)[..., None, :]
    return pi_c, torch.cat([dn, dd], dim=-2)


def plane_edge_terms(
    T_cw: torch.Tensor,
    pi_w: torch.Tensor,  # (*B, N, 4) map planes (world, unit normal)
    pi_obs: torch.Tensor,  # (*B, N, 4) observed planes (camera frame)
    kind: torch.Tensor,  # (*B, N) 0 full (angle + distance), 1 parallel, 2 vertical
):
    """The plane edge taxonomy (EdgePlane, EdgeParallelPlane,
    EdgeVerticalPlane): kind 0 and 1 measure |n_obs x n_pred| (the sine of
    the normal angle; the reference's azimuth/elevation split is singular
    for camera-facing walls), kind 0 adds d_obs - d_pred, kind 2 measures
    n_obs . n_pred. Returns (r (*B, N, 3), J (*B, N, 3, 6), comp (*B, N, 3)
    active-component mask); the weight layout is (angle, unused, distance)."""
    pi_c, J_pi = plane_residual(T_cw, pi_w)
    n = pi_c[..., :3]
    Jn = J_pi[..., :3, :]
    n_obs = pi_obs[..., :3]
    cx = torch.linalg.cross(n_obs, n, dim=-1)
    r_par = torch.linalg.norm(cx, dim=-1)
    dr_dn = torch.einsum("...i,...ij->...j", cx, se3.hat(n_obs)) / torch.clamp(r_par, min=1e-9)[..., None]
    J_par = torch.einsum("...i,...ij->...j", dr_dn, Jn)
    r_d = pi_obs[..., 3] - pi_c[..., 3]
    J_d = -J_pi[..., 3, :]
    r_vert = torch.sum(n_obs * n, dim=-1)
    J_vert = torch.einsum("...i,...ij->...j", n_obs, Jn)
    is_full = kind == 0
    pf = (kind == 1) | is_full
    r0 = torch.where(pf, r_par, r_vert)
    J0 = torch.where(pf[..., None], J_par, J_vert)
    zeros = torch.zeros_like(r0)
    r = torch.stack([r0, zeros, torch.where(is_full, r_d, zeros)], dim=-1)
    J = torch.stack([J0, torch.zeros_like(J0), torch.where(is_full[..., None], J_d, torch.zeros_like(J_d))], dim=-2)
    comp = torch.stack([torch.ones_like(r0), zeros, is_full.to(r0.dtype)], dim=-1)
    return r, J, comp


def plane_minimal_error(pi_obs: torch.Tensor, pi_pred: torch.Tensor) -> torch.Tensor:
    """3-DoF plane error (d_azimuth wrapped to [-pi, pi], d_elevation,
    d_distance), the structure of `Plane3D::ominus`
    (g2oAddition/Plane3D.h:99-113) without its point-cloud term."""
    def azel(pi):
        n = pi[..., :3]
        return torch.stack(
            [torch.atan2(n[..., 1], n[..., 0]),
             torch.atan2(n[..., 2], torch.linalg.norm(n[..., :2], dim=-1))],
            dim=-1,
        )

    dae = azel(pi_obs) - azel(pi_pred)
    dae = torch.where(dae > math.pi, dae - 2 * math.pi, dae)
    dae = torch.where(dae < -math.pi, dae + 2 * math.pi, dae)
    return torch.cat([dae, (pi_obs[..., 3] - pi_pred[..., 3])[..., None]], dim=-1)


def plane_edge_terms_t(
    T_cw: torch.Tensor,
    pi_w: torch.Tensor,
    pi_obs: torch.Tensor,
    kind: torch.Tensor,
):
    """Edge-axis-last plane edge taxonomy: (r (*B, 3, N), Jt (*B, 3, 6, N),
    comp (*B, 3, N)). The residuals of `plane_edge_terms`; the Jacobian rows
    are [0 | n_c x dr_dn] (angle), [n_c | 0] (distance, full edges only)
    and [0 | n_c x n_obs] (vertical)."""
    R = T_cw[..., :3, :3]
    n_c = pi_w[..., :3] @ R.transpose(-1, -2)
    d_c = pi_w[..., 3] - torch.sum(n_c * T_cw[..., None, :3, 3], dim=-1)
    n_obs = pi_obs[..., :3]
    cx = torch.linalg.cross(n_obs, n_c, dim=-1)
    r_par = torch.linalg.norm(cx, dim=-1)
    dr_dn = torch.linalg.cross(cx, n_obs, dim=-1) / torch.clamp(r_par, min=1e-9)[..., None]
    rot_par = torch.linalg.cross(n_c, dr_dn, dim=-1)
    rot_vert = torch.linalg.cross(n_c, n_obs, dim=-1)
    r_d = pi_obs[..., 3] - d_c
    r_vert = torch.sum(n_obs * n_c, dim=-1)
    is_full = kind == 0
    pf = (kind == 1) | is_full
    r0 = torch.where(pf, r_par, r_vert)
    rot0 = torch.where(pf[..., None], rot_par, rot_vert)
    zero = torch.zeros_like(r0)
    fullf = is_full.to(r0.dtype)
    r = torch.stack([r0, zero, torch.where(is_full, r_d, zero)], dim=-2)
    row0 = torch.stack([zero, zero, zero, rot0[..., 0], rot0[..., 1], rot0[..., 2]], dim=-2)
    row2 = torch.stack([n_c[..., 0] * fullf, n_c[..., 1] * fullf, n_c[..., 2] * fullf, zero, zero, zero], dim=-2)
    Jt = torch.stack([row0, torch.zeros_like(row0), row2], dim=-3)
    comp = torch.stack([torch.ones_like(r0), zero, fullf], dim=-2)
    return r, Jt, comp
