"""Pose-only Levenberg-Marquardt over batched point, line and direction edges.

Port of `hfvo_tpu.solve.lm.pose_optimization` (reference:
`Optimizer::PoseOptimization`, src/Optimizer.cc:590-1478): 4 rounds x 10
iterations, per-round chi2 re-classification (5.991 mono / 7.815 stereo /
3.84 line / 3.84 direction), Huber kernels in rounds 0-1 only,
deferred-accept LM, and the convergence exit gated on accepted steps. The
visited (pose, lambda) sequence is the JAX package's: its while loop runs
two done-masked iterations per step and stops once done, which is the loop
below. Besides point edges it takes line-endpoint, line-direction and plane
edges, per-axis rotation anchors and the metric 3D point term. Where the JAX package passes an empty edge table
to keep its traced shapes (`_empty_line_obs`, `_empty_plane_obs`), an
absent table is None here.

It also optimizes S poses at once: T_cw0 (S, 4, 4) against edge tables with
a leading (S,) axis. Each sequence keeps its own cost, lambda, convergence
flag and rejection count, and the loop ends once every sequence is done, as
`jax.vmap` of the while loop does; a done sequence's state no longer
changes, so each sequence visits the (pose, lambda) sequence it visits
alone.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import tracing
from ..geometry import se3
from ..geometry.camera import Intrinsics
from . import residuals


class PoseObs(NamedTuple):
    """Fixed-capacity unary point-edge table for one frame: obs rows are
    (u, v, u_r); `is_stereo` zeroes the u_r component for mono edges;
    `inv_sigma2` is the per-edge information scale (1/1.2^(2*octave)).
    `X_c_obs`, when given, adds a metric 3D alignment residual
    T X_w - X_c_obs for the depth-measured camera points (restricted to
    `valid_3d`, else to the stereo edges): it breaks the planar-view
    valleys of pure image residuals with the depth RGB-D provides."""

    X_w: torch.Tensor  # (N, 3)
    obs: torch.Tensor  # (N, 3)
    is_stereo: torch.Tensor  # (N,) bool
    inv_sigma2: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool
    X_c_obs: Optional[torch.Tensor] = None  # (N, 3) depth-measured camera points
    valid_3d: Optional[torch.Tensor] = None  # (N,) restrict the 3D edges (default is_stereo)


class LineObs(NamedTuple):
    """Line-endpoint edges: a 3D endpoint against the observed 2D line
    (include/EdgeLine.h:155 `EdgeLineProjectXYZOnlyPose`; each map line
    contributes one edge per endpoint)."""

    X_w: torch.Tensor  # (M, 3) an endpoint
    line2d: torch.Tensor  # (M, 3) normalized (a, b, c)
    inv_sigma2: torch.Tensor  # (M,)
    valid: torch.Tensor  # (M,) bool


class DirObs(NamedTuple):
    """Line-direction (vanishing-point) edges: a matched map line's world
    direction rotated by the pose against the frame's depth-fitted 3D
    direction, as the chord residual R d_w - d_c (reference:
    DistVp2VpOnlyPose, include/g2oMSC.h:766-848, src/Optimizer.cc:820-860).
    Translation-free."""

    d_w: torch.Tensor  # (V, 3) map-line direction, world frame (unit)
    d_c: torch.Tensor  # (V, 3) observed 3D-line direction, camera frame (unit)
    inv_sigma2: torch.Tensor  # (V,)
    valid: torch.Tensor  # (V,) bool


class PlaneObs(NamedTuple):
    """Plane edges (reference: EdgePlaneOnlyPose, EdgeParallelPlaneOnlyPose,
    EdgeVerticalPlaneOnlyPose, built by PoseOptimization,
    src/Optimizer.cc:900-1000). kind: 0 full (angle, distance), 1 parallel,
    2 vertical; weight holds the per-component information, (angle_info,
    angle_info, distance_info) for full edges and (parallel or
    vertical_info, 0, 0) for constraint edges."""

    pi_w: torch.Tensor  # (P, 4) map plane, world, unit normal
    pi_obs: torch.Tensor  # (P, 4) observed plane, camera frame
    kind: torch.Tensor  # (P,) int
    weight: torch.Tensor  # (P, 3)
    chi2_th: torch.Tensor  # (P,) gate (Plane.Chi / Plane.VPChi)
    valid: torch.Tensor  # (P,) bool


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor  # (*B, 4, 4)
    inlier: torch.Tensor  # (*B, N) bool point-edge inliers after gating
    n_inliers: torch.Tensor  # (*B,) int64
    chi2: torch.Tensor  # (*B,) total inlier chi2
    line_inlier: torch.Tensor  # (*B, M) bool line-edge inliers ((*B, 0) without lines)
    plane_inlier: torch.Tensor  # (*B, P) bool plane-edge inliers ((*B, 0) without planes)


def _point_terms(T, pts: PoseObs, intr):
    r, Jt, z = residuals.point_stereo_terms_t(T, pts.X_w, pts.obs, intr)
    one = torch.ones_like(pts.inv_sigma2)
    comp = torch.stack([one, one, pts.is_stereo.to(r.dtype)], dim=-2)
    chi2 = torch.sum(r * r * comp, dim=-2) * pts.inv_sigma2
    return r, Jt, comp, chi2, z > 1e-3


def _point3d_terms(T, pts: PoseObs, inv_sigma2_3d: float):
    r, Jt = residuals.point3d_terms_t(T, pts.X_w, pts.X_c_obs)
    has = pts.is_stereo if pts.valid_3d is None else pts.valid_3d
    return r, Jt, torch.sum(r * r, dim=-2) * inv_sigma2_3d, has


def _line_terms(T, lines: LineObs, intr):
    r, Jt, z = residuals.line_terms_t(T, lines.X_w, lines.line2d, intr)
    return r, Jt, (r ** 2) * lines.inv_sigma2, z > 1e-3


def _dir_terms(T, dirs: DirObs):
    r, Jt = residuals.dir_terms_t(T, dirs.d_w, dirs.d_c)
    return r, Jt, torch.sum(r * r, dim=-2) * dirs.inv_sigma2


def _plane_terms(T, pl: PlaneObs):
    r, Jt, comp = residuals.plane_edge_terms_t(T, pl.pi_w, pl.pi_obs, pl.kind)
    wt = pl.weight.transpose(-1, -2)
    return r, Jt, comp, torch.sum(r * r * comp * wt, dim=-2)


def _axis_terms(T, axes_c, axes_w):
    """Per-axis rotation anchors: r_k = R_cw a_w,k - a_c,k (*B, 3, 3) with
    the rotation-block Jacobian -hat(R_cw a_w,k) (*B, 3, 3, 3); the
    translation block is zero."""
    V = axes_w @ T[..., :3, :3].transpose(-1, -2)
    return V - axes_c, -se3.hat(V)


def _huber_scale(chi2: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    return torch.clamp(delta / torch.sqrt(torch.clamp(chi2, min=1e-12)), max=1.0)


def pose_optimization(
    T_cw0: torch.Tensor,
    pts: PoseObs,
    intr: Intrinsics,
    lines: Optional[LineObs] = None,
    planes: Optional[PlaneObs] = None,
    dirs: Optional[DirObs] = None,
    axes_c: Optional[torch.Tensor] = None,
    axes_w: Optional[torch.Tensor] = None,
    w_axis=0.0,
    n_rounds: int = 4,
    n_iters: int = 10,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    chi2_line: float = 3.84,
    chi2_vp: float = 3.84,
    chi2_3d: float = 7.815,
    inv_sigma2_3d: float = 400.0,  # sigma = 5 cm metric alignment
) -> PoseOptResult:
    """Optimize one camera pose against fixed landmarks: point edges, and
    optionally line-endpoint, plane and line-direction edges and per-axis
    rotation anchors.

    `axes_c` / `axes_w` / `w_axis`: row k of `axes_c` (*B, 3, 3) is a
    direction measured in the camera frame (a Manhattan axis mean-shifted
    from the frame's normals), row k of `axes_w` the matching world
    direction; the residual R_cw a_w - a_c is weighted by w_axis[..., k]
    (0 switches that axis off). Each anchor pins the 2 rotation DOF its
    observations measure. With `pts.X_c_obs`, the depth-measured points add
    metric 3D residuals (information `inv_sigma2_3d`, gate `chi2_3d`)."""
    use_3d = pts.X_c_obs is not None
    dev, dt = T_cw0.device, T_cw0.dtype
    th_pt = torch.where(
        pts.is_stereo,
        torch.tensor(chi2_stereo, dtype=dt, device=dev),
        torch.tensor(chi2_mono, dtype=dt, device=dev),
    )
    delta_pt = torch.sqrt(th_pt)
    delta_ln = torch.sqrt(torch.tensor(chi2_line, dtype=dt, device=dev))
    delta_vp = torch.sqrt(torch.tensor(chi2_vp, dtype=dt, device=dev))
    delta_3d = torch.sqrt(torch.tensor(chi2_3d, dtype=dt, device=dev))
    delta_pl = torch.sqrt(planes.chi2_th) if planes is not None else None
    eye6 = torch.eye(6, dtype=dt, device=dev)
    if axes_c is not None:
        wa = torch.as_tensor(w_axis, dtype=dt, device=dev).expand(axes_c.shape[:-1])

    def build_normal_eqs(T, inliers, robust):
        pt_inlier, ln_inlier, pl_inlier, p3_inlier, vp_inlier = inliers
        r, J, comp, chi2, okd = _point_terms(T, pts, intr)
        active = pts.valid & pt_inlier & okd
        w = torch.where(active, pts.inv_sigma2, torch.zeros_like(chi2))
        if robust:
            w = w * _huber_scale(chi2, delta_pt)
        Wc = w[..., None, :] * comp  # (*B, 3, N)
        H = torch.einsum("...kin,...kn,...kjn->...ij", J, Wc, J)
        g = torch.einsum("...kin,...kn->...i", J, Wc * r)
        total = torch.sum(torch.where(active, chi2, torch.zeros_like(chi2)), dim=-1)
        if lines is not None:
            rl, Jl, chi2l, okdl = _line_terms(T, lines, intr)
            activel = lines.valid & ln_inlier & okdl
            wl = torch.where(activel, lines.inv_sigma2, torch.zeros_like(chi2l))
            if robust:
                wl = wl * _huber_scale(chi2l, delta_ln)
            H = H + torch.einsum("...in,...n,...jn->...ij", Jl, wl, Jl)
            g = g + torch.einsum("...in,...n->...i", Jl, wl * rl)
            total = total + torch.sum(torch.where(activel, chi2l, torch.zeros_like(chi2l)), dim=-1)
        if planes is not None:
            rp, Jp, compp, chi2p = _plane_terms(T, planes)
            activep = planes.valid & pl_inlier
            wp = torch.where(activep[..., None, :], planes.weight.transpose(-1, -2) * compp,
                             torch.zeros_like(compp))
            if robust:
                wp = wp * _huber_scale(chi2p, delta_pl)[..., None, :]
            H = H + torch.einsum("...kin,...kn,...kjn->...ij", Jp, wp, Jp)
            g = g + torch.einsum("...kin,...kn->...i", Jp, wp * rp)
            total = total + torch.sum(torch.where(activep, chi2p, torch.zeros_like(chi2p)), dim=-1)
        if use_3d:
            r3, J3, chi23, has3 = _point3d_terms(T, pts, inv_sigma2_3d)
            active3 = pts.valid & has3 & p3_inlier
            w3 = torch.where(active3, torch.full_like(chi23, inv_sigma2_3d), torch.zeros_like(chi23))
            if robust:
                w3 = w3 * _huber_scale(chi23, delta_3d)
            H = H + torch.einsum("...kin,...n,...kjn->...ij", J3, w3, J3)
            g = g + torch.einsum("...kin,...kn->...i", J3, w3[..., None, :] * r3)
            total = total + torch.sum(torch.where(active3, chi23, torch.zeros_like(chi23)), dim=-1)
        if dirs is not None:
            rv, Jv, chi2v = _dir_terms(T, dirs)
            activev = dirs.valid & vp_inlier
            wv = torch.where(activev, dirs.inv_sigma2, torch.zeros_like(chi2v))
            if robust:
                wv = wv * _huber_scale(chi2v, delta_vp)
            H = H + torch.einsum("...kin,...n,...kjn->...ij", Jv, wv, Jv)
            g = g + torch.einsum("...kin,...kn->...i", Jv, wv[..., None, :] * rv)
            total = total + torch.sum(torch.where(activev, chi2v, torch.zeros_like(chi2v)), dim=-1)
        if axes_c is not None:
            r_ax, J_ax = _axis_terms(T, axes_c, axes_w)
            Hr = torch.einsum("...aki,...a,...akj->...ij", J_ax, wa, J_ax)
            gr = torch.einsum("...aki,...ak->...i", J_ax, wa[..., None] * r_ax)
            H = H + torch.nn.functional.pad(Hr, (3, 0, 3, 0))
            g = g + torch.nn.functional.pad(gr, (3, 0))
            total = total + torch.sum(wa * torch.sum(r_ax * r_ax, dim=-1), dim=-1)
        return H, g, total

    def propose(T, H, g, lam):
        Hd = H + lam[..., None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-8 * eye6
        delta = -torch.linalg.solve_ex(Hd, g[..., None])[0][..., 0]
        return se3.exp_se3(delta) @ T

    def lm_round(T0, inliers, robust):
        H_b, g_b, c_b = build_normal_eqs(T0, inliers, robust)
        lam = torch.full_like(c_b, 1e-3)
        T_best = T0
        T_try = propose(T0, H_b, g_b, lam)
        done = torch.zeros(c_b.shape, dtype=torch.bool, device=dev)
        rej_rel = torch.zeros(c_b.shape, dtype=torch.int64, device=dev)
        for it in range(0, n_iters, 2):
            # The JAX while loop tests `done` once per two iterations; under
            # a batch it runs until every sequence is done.
            if it > 0:
                tracing.count("lm_test")
                if bool(done.all()):
                    break
            for _ in range(2):
                H, g, c = build_normal_eqs(T_try, inliers, robust)
                ok = (c < c_b) & torch.isfinite(T_try).flatten(-2).all(-1) & ~done
                # Convergence = an accepted step with negligible gain, or two
                # consecutive negligible-margin rejections.
                rel = torch.abs(c_b - c) <= 1e-5 * (c_b + 1e-9)
                rej_rel = torch.where(
                    done, rej_rel,
                    torch.where(~ok & rel, rej_rel + 1, torch.zeros_like(rej_rel)),
                )
                done = done | (ok & rel) | (rej_rel >= 2)
                T_best = torch.where(ok[..., None, None], T_try, T_best)
                H_b = torch.where(ok[..., None, None], H, H_b)
                g_b = torch.where(ok[..., None], g, g_b)
                c_b = torch.where(ok, c, c_b)
                lam = torch.where(
                    done, lam,
                    torch.where(ok, torch.clamp(lam * 0.5, min=1e-7),
                                torch.clamp(lam * 4.0, max=1e4)),
                )
                T_try = propose(T_best, H_b, g_b, lam)
        return T_best

    T = T_cw0
    pt_inlier = torch.ones_like(pts.valid)
    ln_inlier = torch.ones_like(lines.valid) if lines is not None else None
    pl_inlier = torch.ones_like(planes.valid) if planes is not None else None
    p3_inlier = torch.ones_like(pts.valid)
    vp_inlier = torch.ones_like(dirs.valid) if dirs is not None else None
    for rnd in range(n_rounds):
        with tracing.span("lm.round"):
            T = lm_round(T, (pt_inlier, ln_inlier, pl_inlier, p3_inlier, vp_inlier), robust=rnd < 2)
            # Re-classify: outliers with chi2 back under threshold recover
            # (reference: Optimizer.cc:1216-1246).
            _, _, _, chi2, okd = _point_terms(T, pts, intr)
            pt_inlier = (chi2 <= th_pt) & okd
            if lines is not None:
                _, _, chi2l, okdl = _line_terms(T, lines, intr)
                ln_inlier = (chi2l <= chi2_line) & okdl
            if planes is not None:
                pl_inlier = _plane_terms(T, planes)[3] <= planes.chi2_th
            if use_3d:
                p3_inlier = _point3d_terms(T, pts, inv_sigma2_3d)[2] <= chi2_3d
            if dirs is not None:
                vp_inlier = _dir_terms(T, dirs)[2] <= chi2_vp

    pt_inlier = pt_inlier & pts.valid
    *_, chi2, okd = _point_terms(T, pts, intr)
    chi2_final = torch.sum(torch.where(pts.valid & pt_inlier & okd, chi2, torch.zeros_like(chi2)), dim=-1)
    if lines is not None:
        ln_inlier = ln_inlier & lines.valid
        _, _, chi2l, okdl = _line_terms(T, lines, intr)
        activel = lines.valid & ln_inlier & okdl
        chi2_final = chi2_final + torch.sum(torch.where(activel, chi2l, torch.zeros_like(chi2l)), dim=-1)
    else:
        ln_inlier = torch.zeros(T.shape[:-2] + (0,), dtype=torch.bool, device=dev)
    if planes is not None:
        pl_inlier = pl_inlier & planes.valid
        chi2p = _plane_terms(T, planes)[3]
        chi2_final = chi2_final + torch.sum(torch.where(pl_inlier, chi2p, torch.zeros_like(chi2p)), dim=-1)
    else:
        pl_inlier = torch.zeros(T.shape[:-2] + (0,), dtype=torch.bool, device=dev)
    if use_3d:
        _, _, chi23, has3 = _point3d_terms(T, pts, inv_sigma2_3d)
        active3 = pts.valid & has3 & p3_inlier
        chi2_final = chi2_final + torch.sum(torch.where(active3, chi23, torch.zeros_like(chi23)), dim=-1)
    if dirs is not None:
        chi2v = _dir_terms(T, dirs)[2]
        activev = dirs.valid & vp_inlier
        chi2_final = chi2_final + torch.sum(torch.where(activev, chi2v, torch.zeros_like(chi2v)), dim=-1)
    if axes_c is not None:
        r_ax = _axis_terms(T, axes_c, axes_w)[0]
        chi2_final = chi2_final + torch.sum(wa * torch.sum(r_ax * r_ax, dim=-1), dim=-1)
    return PoseOptResult(T, pt_inlier, torch.sum(pt_inlier, dim=-1), chi2_final, ln_inlier, pl_inlier)
