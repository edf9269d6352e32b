"""Pose-only Levenberg-Marquardt over batched point edges.

Port of `hfvo_tpu.solve.lm.pose_optimization` for point edges (reference:
`Optimizer::PoseOptimization`, src/Optimizer.cc:590-1478): 4 rounds x 10
iterations, per-round chi2 re-classification (5.991 mono / 7.815 stereo),
Huber kernels in rounds 0-1 only, deferred-accept LM, and the convergence
exit gated on accepted steps. The visited (pose, lambda) sequence is the
JAX package's: its while loop runs two done-masked iterations per step and
stops once done, which is the loop below. Line, plane, direction and axis
edges (and the metric 3D term) come with later slices.
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


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor  # (4, 4)
    inlier: torch.Tensor  # (N,) bool point-edge inliers after gating
    n_inliers: torch.Tensor  # scalar int64
    chi2: torch.Tensor  # scalar total inlier chi2


def _point_terms(T, pts: PoseObs, intr):
    r, Jt, z = residuals.point_stereo_terms_t(T, pts.X_w, pts.obs, intr)
    one = torch.ones_like(pts.inv_sigma2)
    comp = torch.stack([one, one, pts.is_stereo.to(r.dtype)], dim=0)
    chi2 = torch.sum(r * r * comp, dim=0) * pts.inv_sigma2
    return r, Jt, comp, chi2, z > 1e-3


def pose_optimization(
    T_cw0: torch.Tensor,
    pts: PoseObs,
    intr: Intrinsics,
    lines=None,
    planes=None,
    dirs=None,
    axes_c=None,
    n_rounds: int = 4,
    n_iters: int = 10,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
) -> PoseOptResult:
    """Optimize one camera pose against fixed landmarks (points only)."""
    if lines is not None or planes is not None or dirs is not None or axes_c is not None:
        raise NotImplementedError(
            "pose_optimization: line, plane, direction and axis edges arrive "
            "with the lines and planes+Manhattan slices"
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
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def build_normal_eqs(T, inlier, robust):
        r, J, comp, chi2, okd = _point_terms(T, pts, intr)
        active = pts.valid & inlier & okd
        w = torch.where(active, pts.inv_sigma2, torch.zeros_like(chi2))
        if robust:
            w = w * torch.clamp(delta_pt / torch.sqrt(torch.clamp(chi2, min=1e-12)), max=1.0)
        Wc = w[None, :] * comp  # (3, N)
        H = torch.einsum("kin,kn,kjn->ij", J, Wc, J)
        g = torch.einsum("kin,kn->i", J, Wc * r)
        total = torch.sum(torch.where(active, chi2, torch.zeros_like(chi2)))
        return H, g, total

    def propose(T, H, g, lam):
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
        delta = -torch.linalg.solve_ex(Hd, g[:, None])[0][:, 0]
        return se3.exp_se3(delta) @ T

    def lm_round(T0, inlier, robust):
        H_b, g_b, c_b = build_normal_eqs(T0, inlier, robust)
        lam = torch.tensor(1e-3, dtype=dt, device=dev)
        T_best = T0
        T_try = propose(T0, H_b, g_b, lam)
        done = torch.tensor(False, device=dev)
        rej_rel = torch.tensor(0, device=dev)
        for it in range(0, n_iters, 2):
            # The JAX while loop tests `done` once per two iterations.
            if it > 0 and bool(done):
                break
            for _ in range(2):
                H, g, c = build_normal_eqs(T_try, inlier, robust)
                ok = (c < c_b) & torch.all(torch.isfinite(T_try)) & ~done
                # Convergence = an accepted step with negligible gain, or two
                # consecutive negligible-margin rejections.
                rel = torch.abs(c_b - c) <= 1e-5 * (c_b + 1e-9)
                rej_rel = torch.where(
                    done, rej_rel,
                    torch.where(~ok & rel, rej_rel + 1, torch.zeros_like(rej_rel)),
                )
                done = done | (ok & rel) | (rej_rel >= 2)
                T_best = torch.where(ok, T_try, T_best)
                H_b = torch.where(ok, H, H_b)
                g_b = torch.where(ok, g, g_b)
                c_b = torch.where(ok, c, c_b)
                lam = torch.where(
                    done, lam,
                    torch.where(ok, torch.clamp(lam * 0.5, min=1e-7),
                                torch.clamp(lam * 4.0, max=1e4)),
                )
                T_try = propose(T_best, H_b, g_b, lam)
        return T_best

    T = T_cw0
    inlier = torch.ones_like(pts.valid)
    for rnd in range(n_rounds):
        T = lm_round(T, inlier, robust=rnd < 2)
        # Re-classify: outliers with chi2 back under threshold recover
        # (reference: Optimizer.cc:1216-1246).
        _, _, _, chi2, okd = _point_terms(T, pts, intr)
        inlier = (chi2 <= th_pt) & okd

    inlier = inlier & pts.valid
    *_, chi2, okd = _point_terms(T, pts, intr)
    active = pts.valid & inlier & okd
    chi2_final = torch.sum(torch.where(active, chi2, torch.zeros_like(chi2)))
    return PoseOptResult(T, inlier, torch.sum(inlier), chi2_final)
