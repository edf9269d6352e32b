"""Pose-only Levenberg-Marquardt over batched point, line and direction edges.

Port of `hfvo_tpu.solve.lm.pose_optimization` (reference:
`Optimizer::PoseOptimization`, src/Optimizer.cc:590-1478): 4 rounds x 10
iterations, per-round chi2 re-classification (5.991 mono / 7.815 stereo /
3.84 line / 3.84 direction), Huber kernels in rounds 0-1 only,
deferred-accept LM, and the convergence exit gated on accepted steps. The
visited (pose, lambda) sequence is the JAX package's: its while loop runs
two done-masked iterations per step and stops once done, which is the loop
below. Plane and axis edges (and the metric 3D term) come with later
slices.

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

from ..geometry import se3
from ..geometry.camera import Intrinsics
from . import residuals


class PoseObs(NamedTuple):
    """Fixed-capacity unary point-edge table for one frame: obs rows are
    (u, v, u_r); `is_stereo` zeroes the u_r component for mono edges;
    `inv_sigma2` is the per-edge information scale (1/1.2^(2*octave))."""

    X_w: torch.Tensor  # (N, 3)
    obs: torch.Tensor  # (N, 3)
    is_stereo: torch.Tensor  # (N,) bool
    inv_sigma2: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool
    X_c_obs: Optional[torch.Tensor] = None  # metric 3D term: a later slice


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


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor  # (*B, 4, 4)
    inlier: torch.Tensor  # (*B, N) bool point-edge inliers after gating
    n_inliers: torch.Tensor  # (*B,) int64
    chi2: torch.Tensor  # (*B,) total inlier chi2
    line_inlier: torch.Tensor  # (*B, M) bool line-edge inliers ((*B, 0) without lines)


def _point_terms(T, pts: PoseObs, intr):
    r, Jt, z = residuals.point_stereo_terms_t(T, pts.X_w, pts.obs, intr)
    one = torch.ones_like(pts.inv_sigma2)
    comp = torch.stack([one, one, pts.is_stereo.to(r.dtype)], dim=-2)
    chi2 = torch.sum(r * r * comp, dim=-2) * pts.inv_sigma2
    return r, Jt, comp, chi2, z > 1e-3


def _line_terms(T, lines: LineObs, intr):
    r, Jt, z = residuals.line_terms_t(T, lines.X_w, lines.line2d, intr)
    return r, Jt, (r ** 2) * lines.inv_sigma2, z > 1e-3


def _dir_terms(T, dirs: DirObs):
    r, Jt = residuals.dir_terms_t(T, dirs.d_w, dirs.d_c)
    return r, Jt, torch.sum(r * r, dim=-2) * dirs.inv_sigma2


def _huber_scale(chi2: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    return torch.clamp(delta / torch.sqrt(torch.clamp(chi2, min=1e-12)), max=1.0)


def pose_optimization(
    T_cw0: torch.Tensor,
    pts: PoseObs,
    intr: Intrinsics,
    lines: Optional[LineObs] = None,
    planes=None,
    dirs: Optional[DirObs] = None,
    axes_c=None,
    n_rounds: int = 4,
    n_iters: int = 10,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    chi2_line: float = 3.84,
    chi2_vp: float = 3.84,
) -> PoseOptResult:
    """Optimize one camera pose against fixed landmarks: point edges, and
    optionally line-endpoint and line-direction edges."""
    if planes is not None or axes_c is not None:
        raise NotImplementedError(
            "pose_optimization: plane and axis edges arrive with the "
            "planes+Manhattan slice"
        )
    if pts.X_c_obs is not None:
        raise NotImplementedError(
            "pose_optimization: the metric 3D point term (inv_sigma2_3d > 0) "
            "arrives with the relocalization slice (it seeds from a 3D-3D RANSAC)"
        )
    dev, dt = T_cw0.device, T_cw0.dtype
    th_pt = torch.where(
        pts.is_stereo,
        torch.tensor(chi2_stereo, dtype=dt, device=dev),
        torch.tensor(chi2_mono, dtype=dt, device=dev),
    )
    delta_pt = torch.sqrt(th_pt)
    delta_ln = torch.sqrt(torch.tensor(chi2_line, dtype=dt, device=dev))
    delta_vp = torch.sqrt(torch.tensor(chi2_vp, dtype=dt, device=dev))
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def build_normal_eqs(T, inliers, robust):
        pt_inlier, ln_inlier, vp_inlier = inliers
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
        if dirs is not None:
            rv, Jv, chi2v = _dir_terms(T, dirs)
            activev = dirs.valid & vp_inlier
            wv = torch.where(activev, dirs.inv_sigma2, torch.zeros_like(chi2v))
            if robust:
                wv = wv * _huber_scale(chi2v, delta_vp)
            H = H + torch.einsum("...kin,...n,...kjn->...ij", Jv, wv, Jv)
            g = g + torch.einsum("...kin,...kn->...i", Jv, wv[..., None, :] * rv)
            total = total + torch.sum(torch.where(activev, chi2v, torch.zeros_like(chi2v)), dim=-1)
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
            if it > 0 and bool(done.all()):
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
    vp_inlier = torch.ones_like(dirs.valid) if dirs is not None else None
    for rnd in range(n_rounds):
        T = lm_round(T, (pt_inlier, ln_inlier, vp_inlier), robust=rnd < 2)
        # Re-classify: outliers with chi2 back under threshold recover
        # (reference: Optimizer.cc:1216-1246).
        _, _, _, chi2, okd = _point_terms(T, pts, intr)
        pt_inlier = (chi2 <= th_pt) & okd
        if lines is not None:
            _, _, chi2l, okdl = _line_terms(T, lines, intr)
            ln_inlier = (chi2l <= chi2_line) & okdl
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
    if dirs is not None:
        chi2v = _dir_terms(T, dirs)[2]
        activev = dirs.valid & vp_inlier
        chi2_final = chi2_final + torch.sum(torch.where(activev, chi2v, torch.zeros_like(chi2v)), dim=-1)
    return PoseOptResult(T, pt_inlier, torch.sum(pt_inlier, dim=-1), chi2_final, ln_inlier)
