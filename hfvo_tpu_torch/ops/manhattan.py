"""Manhattan-frame estimation: mean-shift axis tracking, coarse and fine init.

Port of `hfvo_tpu.ops.manhattan` (reference: `Tracking::TrackManhattanFrame`,
src/Tracking.cc:1172-1348, with `MeanShift` :1152;
`Manhattan::extractCoarseManhAxes`, src/Manhattan.cpp:555-740;
`Optimizer::MultiViewManhInit`, src/Optimizer.cc:3942-4338):

- `measure_axes` / `refine_axes`: per axis, gate the sign-folded
  observation directions (surface normals, line directions) by a cone,
  project them onto the axis' tangent plane and take the Gaussian-kernel
  mean shift; `refine_axes` then completes a missing axis by a cross
  product and re-orthonormalizes by SVD.
- `coarse_manhattan_init`: refine 24 seeded and 40 fixed quasi-random
  rotation hypotheses, keep the first with the highest support rate.
- `multiview_manh_init`: Levenberg-Marquardt over three free axis vectors
  against map-line directions, three damped 3x3 solves an iteration.

The mean-shift functions take leading batch dims on the rotation: R_cm
(*B, 3, 3) against directions (*B, N, 3) (the fused step's sequences, or
the coarse init's hypotheses against one set of directions).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..geometry import se3


def _fold(dirs: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Flip directions into the hemisphere of `axis` (normals and line
    directions are sign-ambiguous)."""
    s = torch.sign(torch.sum(dirs * axis, dim=-1, keepdim=True))
    return dirs * torch.where(s == 0, 1.0, s)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)


def measure_axes(
    R_cm: torch.Tensor,
    dirs: torch.Tensor,
    weights: torch.Tensor,
    cone: float = 0.2018,
    kernel: float = 20.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One mean-shift step per axis: (rows = measured axis directions in
    the camera frame (*B, 3, 3), support counts (*B, 3)). No cross
    completion or joint orthonormalization, so a weakly supported axis
    cannot corrupt a well supported one."""
    cos_cone = math.cos(cone)
    axes = R_cm.transpose(-1, -2)  # rows = axes
    new_axes, supports = [], []
    for a in range(3):
        axis = axes[..., a, :]
        d = _fold(dirs, axis[..., None, :])
        cosang = torch.sum(d * axis[..., None, :], dim=-1)
        gate = (cosang > cos_cone) & (weights > 0)
        # Tangent-plane projection (reference ProjectSN2MF).
        perp = d - cosang[..., None] * axis[..., None, :]
        w = torch.where(gate, weights * torch.exp(-kernel * torch.sum(perp * perp, dim=-1)), 0.0)
        sw = torch.sum(w, dim=-1)
        shift = torch.sum(w[..., None] * perp, dim=-2) / torch.clamp(sw, min=1e-9)[..., None]
        new_axis = axis + shift
        new_axis = new_axis / (torch.linalg.norm(new_axis, dim=-1, keepdim=True) + 1e-12)
        new_axes.append(torch.where((sw > 1e-6)[..., None], new_axis, axis))
        supports.append(torch.sum(gate, dim=-1))
    return torch.stack(new_axes, dim=-2), torch.stack(supports, dim=-1)


def complete_axes(A: torch.Tensor, sup: torch.Tensor) -> torch.Tensor:
    """Rows of measured axes -> SO(3) (columns = axes): an axis without
    support is the cross product of the others (keeping handedness), then
    the SVD projection (src/Tracking.cc:1292-1339)."""
    s = sup > 0
    a0 = torch.where(s[..., 0:1], A[..., 0, :], _unit(torch.linalg.cross(A[..., 1, :], A[..., 2, :], dim=-1)))
    a1 = torch.where(s[..., 1:2], A[..., 1, :], _unit(torch.linalg.cross(A[..., 2, :], a0, dim=-1)))
    a2 = torch.where(s[..., 2:3], A[..., 2, :], _unit(torch.linalg.cross(a0, a1, dim=-1)))
    return se3.orthonormalize(torch.stack([a0, a1, a2], dim=-1))


def refine_axes(
    R_cm: torch.Tensor,  # (*B, 3, 3) columns = Manhattan axes in the camera frame
    dirs: torch.Tensor,  # (*B, N, 3) unit observation directions
    weights: torch.Tensor,  # (*B, N) observation weights (0 = invalid)
    cone: float = 0.2018,  # conic half-angle gate (radians)
    n_iters: int = 1,
    kernel: float = 20.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-shift refinement of the Manhattan rotation: (R_cm (*B, 3, 3),
    per-axis support counts of the last iteration (*B, 3))."""
    sup = torch.zeros(R_cm.shape[:-1], dtype=torch.int64, device=R_cm.device)
    for _ in range(n_iters):
        A, sup = measure_axes(R_cm, dirs, weights, cone, kernel)
        R_cm = complete_axes(A, sup)
    return R_cm, sup


def support_rate(R_cm: torch.Tensor, dirs: torch.Tensor, weights: torch.Tensor,
                 cone: float = 0.2018) -> torch.Tensor:
    """Fraction of valid directions within the cone of some axis."""
    axes = R_cm.transpose(-1, -2)
    cosang = torch.abs(torch.sum(dirs[..., :, None, :] * axes[..., None, :, :], dim=-1))  # (*B, N, 3)
    near = torch.any(cosang > math.cos(cone), dim=-1)
    ok = weights > 0
    return torch.sum(near & ok, dim=-1).float() / torch.clamp(torch.sum(ok, dim=-1).float(), min=1.0)


def _hypothesis_rotations(n_random: int = 40) -> np.ndarray:
    """The fixed quasi-random rotation hypotheses (H, 3, 3) float32, drawn
    with the JAX package's seed and recipe (hfvo_tpu/ops/manhattan.py:135-146)."""
    rs = np.random.RandomState(11)
    qs = rs.normal(size=(n_random, 4))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    return se3.mat_from_quat(torch.from_numpy(qs.astype(np.float32))).numpy()


_FIXED_HYPS = _hypothesis_rotations()


def coarse_manhattan_init(
    dirs: torch.Tensor,  # (N, 3) normals + line directions, camera frame
    weights: torch.Tensor,  # (N,)
    seed_pairs: torch.Tensor,  # (Sp, 2, 3) direction pairs to seed rotations
    cone: float = 0.2018,
    n_refine: int = 4,
):
    """Hypothesis search for the initial Manhattan rotation: (R_cm (3, 3),
    support rate). The caller accepts it above the reference's 0.95
    (src/Tracking.cc:573). Among equal rates the first hypothesis wins."""
    # Seeded hypotheses: a = first dir; b = orthogonalized second; c = a x b.
    a = seed_pairs[:, 0]
    a = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + 1e-9)
    b0 = seed_pairs[:, 1]
    b = b0 - torch.sum(b0 * a, dim=-1, keepdim=True) * a
    bn = torch.linalg.norm(b, dim=-1, keepdim=True)
    b = b / torch.clamp(bn, min=1e-6)
    seeded = torch.stack([a, b, torch.linalg.cross(a, b, dim=-1)], dim=-1)  # columns = axes
    eye = torch.eye(3, device=dirs.device)
    seeded = torch.where((bn[:, 0] > 0.3)[:, None, None], seeded, eye)  # near-parallel pairs
    hyps = torch.cat([seeded, torch.from_numpy(_FIXED_HYPS).to(dirs.device)], dim=0)
    Rs, _ = refine_axes(hyps, dirs, weights, cone=cone, n_iters=n_refine)
    rates = support_rate(Rs, dirs, weights, cone)
    best = torch.argmax(rates)
    return Rs[best], rates[best]


def multiview_manh_init(
    R0: torch.Tensor,  # (3, 3) columns = seed Manhattan axes (world frame)
    d_w: torch.Tensor,  # (L, 3) unit line directions (world frame)
    w: torch.Tensor,  # (L,) observation weights (0 = off)
    axis_idx: torch.Tensor,  # (L,) axis assignment in {-1, 0, 1, 2}
    n_iters: int = 10,
    w_perp: float = 0.25,
    w_unit: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fine Manhattan initialization: LM over three free axis vectors A
    (rows) against the map lines' directions. Each assigned line adds a
    parallel edge cross(unit(a_m), d) to its axis and down-weighted
    perpendicular edges unit(a_k) . d to the other two, under Huber IRLS
    weights; a soft unit-norm residual fixes each vector's scale. The axes
    share no edge, so an iteration is three damped 3x3 solves; the result
    is SVD-projected onto SO(3) (src/Optimizer.cc:4325-4337). Returns
    (R (3, 3) columns = axes, final cost)."""
    dev = d_w.device
    valid = (axis_idx >= 0) & (w > 0)
    onehot = torch.nn.functional.one_hot(torch.clamp(axis_idx, min=0).long(), 3).float()
    wv = torch.where(valid, w, 0.0)[:, None]
    w_par_la0 = wv * onehot  # (L, 3)
    w_perp_la0 = wv * (1.0 - onehot) * w_perp
    # Huber delta at the line cone: a mis-assigned line stops pulling.
    delta = torch.sin(torch.tensor(0.1018, device=dev))
    eye = torch.eye(3, device=dev)

    def normed(A):
        nrm = torch.linalg.norm(A, dim=1, keepdim=True)
        return A / torch.clamp(nrm, min=1e-9), nrm

    def cross_all(An):  # (L, 3 axes, 3) cross(axis_a, d_l)
        return torch.linalg.cross(An[None, :, :].expand(d_w.shape[0], 3, 3),
                                  d_w[:, None, :].expand(d_w.shape[0], 3, 3), dim=-1)

    def cost_of(A, w_par_la, w_perp_la):
        An, _ = normed(A)
        r_par = cross_all(An)
        r_perp = torch.sum(An[None] * d_w[:, None, :], dim=-1)
        c = torch.sum(w_par_la * torch.sum(r_par * r_par, dim=-1))
        c = c + torch.sum(w_perp_la * r_perp * r_perp)
        return c + w_unit * torch.sum((torch.sum(A * A, dim=1) - 1.0) ** 2)

    def irls_weights(A):
        An, _ = normed(A)
        s_par = torch.linalg.norm(cross_all(An), dim=-1)
        s_perp = torch.abs(torch.sum(An[None] * d_w[:, None, :], dim=-1))
        return (w_par_la0 * torch.clamp(delta / torch.clamp(s_par, min=1e-9), max=1.0),
                w_perp_la0 * torch.clamp(delta / torch.clamp(s_perp, min=1e-9), max=1.0))

    Hd = -se3.hat(d_w)  # (L, 3, 3): d cross(An_m, d_l) / d An_m
    A = R0.transpose(0, 1).clone()  # rows = axes
    lam = torch.tensor(1e-3, device=dev)
    for _ in range(n_iters):
        w_par_la, w_perp_la = irls_weights(A)
        An, nrm = normed(A)
        Pn = (eye[None] - An[:, :, None] * An[:, None, :]) / torch.clamp(nrm[:, :, None], min=1e-9)
        r_par = cross_all(An)
        H = torch.einsum("la,lij,lik->ajk", w_par_la, Hd, Hd)
        g = torch.einsum("la,lji,laj->ai", w_par_la, Hd, r_par)
        r_perp = torch.sum(An[None] * d_w[:, None, :], dim=-1)
        H = H + torch.einsum("la,li,lj->aij", w_perp_la, d_w, d_w)
        g = g + torch.einsum("la,la,li->ai", w_perp_la, r_perp, d_w)
        # Chain through d(An)/dA: H_A = Pn^T H Pn, g_A = Pn^T g.
        H = torch.einsum("aij,aik,akl->ajl", Pn, H, Pn)
        g = torch.einsum("aij,ai->aj", Pn, g)
        # Unit-norm residual on raw A: r = |A|^2 - 1, J = 2 A.
        r_u = torch.sum(A * A, dim=1) - 1.0
        H = H + 4.0 * w_unit * A[:, :, None] * A[:, None, :]
        g = g + 2.0 * w_unit * r_u[:, None] * A
        H = H + lam * eye[None] * torch.clamp(torch.diagonal(H, dim1=1, dim2=2), min=1e-6)[:, :, None] * eye[None]
        A_new = A - torch.linalg.solve(H, g[:, :, None])[..., 0]
        accept = (cost_of(A_new, w_par_la, w_perp_la) < cost_of(A, w_par_la, w_perp_la)) \
            & torch.all(torch.isfinite(A_new))
        A = torch.where(accept, A_new, A)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7), torch.clamp(lam * 5.0, max=1e4))
    An, _ = normed(A)
    R = se3.orthonormalize(An.transpose(0, 1))
    return R, cost_of(R.transpose(0, 1), *irls_weights(R.transpose(0, 1)))


def line_axis_assignment(R_cm: torch.Tensor, line_dirs: torch.Tensor, cone: float = 0.1018) -> torch.Tensor:
    """Each line direction's Manhattan axis, or -1 outside the cone
    (reference: Manhattan::LineManhAxisCorresp, src/Manhattan.cpp:1139).
    R_cm (*B, 3, 3), line_dirs (*B, N, 3) -> (*B, N) int64."""
    cosang = torch.abs(line_dirs @ R_cm)  # (*B, N, 3)
    best = torch.argmax(cosang, dim=-1)
    return torch.where(torch.amax(cosang, dim=-1) > math.cos(cone), best, -1)


def plane_seed_pair(
    plane_normals,
    plane_counts,
    plane_valid,
    line_dirs=None,
    ver_th: float = 0.08716,
) -> Optional[np.ndarray]:
    """Seed direction pair (2, 3) float32 for the coarse init from detected
    planes, or None (host numpy; reference: Map::FindManhattan,
    src/Map.cc:150-394): the near-perpendicular plane-normal pair
    (|n1.n2| < ver_th) of most combined support, else a plane normal with
    the most perpendicular 3D line direction."""
    n = np.asarray(plane_normals, np.float32)
    cnt = np.asarray(plane_counts, np.float32)
    ok = np.asarray(plane_valid, bool)
    n, cnt = n[ok], cnt[ok]
    if len(n) >= 2:
        perp = np.abs(n @ n.T) < ver_th
        np.fill_diagonal(perp, False)
        if perp.any():
            support = np.where(perp, cnt[:, None] + cnt[None, :], -1.0)
            i, j = np.unravel_index(np.argmax(support), support.shape)
            return np.stack([n[i], n[j]]).astype(np.float32)
    if len(n) >= 1 and line_dirs is not None and len(line_dirs):
        ld = np.asarray(line_dirs, np.float32)
        ld = ld / (np.linalg.norm(ld, axis=1, keepdims=True) + 1e-9)
        dot = np.abs(n @ ld.T)
        i, j = np.unravel_index(np.argmin(dot), dot.shape)
        if dot[i, j] < ver_th:
            return np.stack([n[i], ld[j]]).astype(np.float32)
    return None
