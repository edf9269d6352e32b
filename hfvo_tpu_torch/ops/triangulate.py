"""Epipolar search + two-view triangulation of new map points, and two-view
line triangulation with a third view's check.

Port of `hfvo_tpu.ops.triangulate` (reference: `LocalMapping::
CreateNewMapPoints`, src/LocalMapping.cc:335-660, and
`CreateNewMapLinesConstraint`, :1064-1203). Every candidate pair of two
keyframes is scored at once: a masked Hamming matrix gated by the
point-to-epipolar-line distance, mutual-best matches, and every match
triangulated as the null vector of its 4x4 DLT normal equations. The
neighbour keyframes of `triangulate_multi` are a leading batch axis of the
same function, as the JAX package vmaps `triangulate_pair` over them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera as camera_ops
from ..geometry import se3
from ..geometry.camera import Intrinsics
from ..ops.batch import take_rows
from . import hamming, sym_eig
from .lines import line_distance_matrix


class TriangulationResult(NamedTuple):
    X_a: torch.Tensor  # (*B, C, 3) new point in frame-A camera coords
    match_b: torch.Tensor  # (*B, C) matched candidate index in B (-1 = none)
    ok: torch.Tensor  # (*B, C) bool — triangulation accepted


class LineTriangulationResult(NamedTuple):
    X0_a: torch.Tensor  # (C, 3) endpoint 0 in frame-A camera coords
    X1_a: torch.Tensor  # (C, 3)
    match_b: torch.Tensor  # (C,) matched segment index in B (-1 = none)
    ok: torch.Tensor  # (C,) bool


def _kinv(intr: Intrinsics, device) -> torch.Tensor:
    return torch.tensor(
        [[1.0 / intr.fx, 0.0, -intr.cx / intr.fx],
         [0.0, 1.0 / intr.fy, -intr.cy / intr.fy],
         [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _dlt_rows(x: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """The two DLT rows of each normalized ray x (*B, C, 3) under the
    projection P (*B, 3, 4): (*B, C, 2, 4)."""
    P = P[..., None, :, :]
    return torch.stack(
        [x[..., 0:1] * P[..., 2, :] - x[..., 2:3] * P[..., 0, :],
         x[..., 1:2] * P[..., 2, :] - x[..., 2:3] * P[..., 1, :]],
        dim=-2,
    )


def triangulate_multi(
    intr: Intrinsics,
    uv_a: torch.Tensor,  # (C, 2) keypoints of KF a (the new keyframe)
    desc_a: torch.Tensor,  # (C, 8) int64 words
    cand_a: torch.Tensor,  # (C,) bool — unmatched, landmark-less keypoints
    oct_a: torch.Tensor,  # (C,) int
    uv_b: torch.Tensor,  # (*B, C, 2) keypoints of the neighbour keyframes
    desc_b: torch.Tensor,  # (*B, C, 8)
    cand_b: torch.Tensor,  # (*B, C) — all-False rows are padding neighbours
    oct_b: torch.Tensor,  # (*B, C)
    T_ab: torch.Tensor,  # (*B, 4, 4) a-camera <- b-camera
    scale_factor: float = 1.2,
    max_hamming: int = 50,
) -> TriangulationResult:
    """Match the candidate keypoints of keyframe a with those of each
    neighbour b along the epipolar geometry and triangulate (reference:
    ORBmatcher::SearchForTriangulation, src/ORBmatcher.cc:668, and the
    acceptance checks of src/LocalMapping.cc:470-650: positive depth in
    both views, parallax, per-view chi2 reprojection gates, octave-scale
    consistency). With no batch dims this is `triangulate_pair`."""
    dev = uv_a.device
    R_ab, t_ab = T_ab[..., :3, :3], T_ab[..., :3, 3]
    Kinv = _kinv(intr, dev)
    # Fundamental matrix b->a: x_a^T F x_b = 0 with F = K^-T [t]x R K^-1.
    F = Kinv.T @ se3.hat(t_ab) @ R_ab @ Kinv
    ha, hb = _homog(uv_a), _homog(uv_b)
    # Distance of each b-keypoint to the epipolar line of each a-keypoint.
    lines_b = ha @ F  # (*B, C, 3)
    num = torch.abs(lines_b @ hb.transpose(-1, -2))  # (*B, Ca, Cb)
    den = torch.sqrt(lines_b[..., 0] ** 2 + lines_b[..., 1] ** 2)[..., None] + 1e-9
    epi_dist = num / den
    sigma2_b = scale_factor ** (2.0 * oct_b.float())
    epi_ok = epi_dist * epi_dist < 3.84 * sigma2_b[..., None, :]

    mask = cand_a[:, None] & cand_b[..., None, :] & epi_ok
    D = hamming.hamming_matrix(desc_a, desc_b)
    b_of_a, mok = hamming.mutual_best(D, mask)
    best_d = torch.gather(D, -1, b_of_a[..., None])[..., 0]
    matched = mok & (best_d <= max_hamming)
    jb = b_of_a

    # Normalized rays in each camera; b's rotated into a for the parallax.
    ray_a = ha @ Kinv.T  # (C, 3)
    xb = take_rows(hb, jb) @ Kinv.T  # (*B, C, 3) in camera b
    ray_b_in_a = xb @ R_ab.transpose(-1, -2)
    cos_par = torch.sum(ray_a * ray_b_in_a, dim=-1) / (
        torch.linalg.norm(ray_a, dim=-1) * torch.linalg.norm(ray_b_in_a, dim=-1) + 1e-9
    )

    # DLT in frame a: P_a = [I|0], P_b = [R_ba|t_ba] (b-cam <- a-cam).
    T_ba = se3.inv(T_ab)
    R_ba, t_ba = T_ba[..., :3, :3], T_ba[..., :3, 3]
    Pa = torch.eye(3, 4, dtype=torch.float32, device=dev)
    Pb = T_ba[..., :3, :]
    A = torch.cat([_dlt_rows(ray_a, Pa).expand(xb.shape[:-1] + (2, 4)), _dlt_rows(xb, Pb)], dim=-2)
    AtA = torch.einsum("...cia,...cib->...cab", A, A)  # (*B, C, 4, 4)
    _, V = sym_eig.eigh4(AtA)  # ascending eigenvalues
    Xh = V[..., :, 0]  # smallest eigenvector
    w = Xh[..., 3]
    X_a = Xh[..., :3] / torch.where(torch.abs(w) > 1e-9, w, torch.ones_like(w))[..., None]
    X_b = X_a @ R_ba.transpose(-1, -2) + t_ba[..., None, :]

    # Acceptance gates (reference: src/LocalMapping.cc:545-650).
    za, zb = X_a[..., 2], X_b[..., 2]
    pr_a = camera_ops.project(intr, X_a)
    pr_b = camera_ops.project(intr, X_b)
    sigma2_a = scale_factor ** (2.0 * oct_a.float())
    err_a = torch.sum((pr_a - uv_a) ** 2, dim=-1)
    err_b = torch.sum((pr_b - take_rows(uv_b, jb)) ** 2, dim=-1)
    reproj_ok = (err_a < 5.991 * sigma2_a) & (err_b < 5.991 * torch.gather(sigma2_b, -1, jb))
    # Scale consistency: the distance ratio must agree with the octave ratio
    # within a factor (reference ratioFactor = 1.5 * scaleFactor).
    dist_a = torch.linalg.norm(X_a, dim=-1)
    dist_b = torch.linalg.norm(X_b, dim=-1)
    ratio_dist = dist_b / torch.clamp(dist_a, min=1e-9)
    ratio_oct = scale_factor ** (oct_a - torch.gather(oct_b, -1, jb)).float()
    rf = 1.5 * scale_factor
    scale_ok = (ratio_dist < ratio_oct * rf) & (ratio_dist * rf > ratio_oct)

    ok = (
        matched
        & (torch.abs(w) > 1e-9)
        & (cos_par < 0.9998)
        & (cos_par > 0.0)
        & (za > 0.05)
        & (zb > 0.05)
        & reproj_ok
        & scale_ok
        & torch.isfinite(X_a).all(dim=-1)
    )
    return TriangulationResult(X_a, torch.where(ok, b_of_a, torch.full_like(b_of_a, -1)), ok)


# One neighbour keyframe: the same function with no batch dims.
triangulate_pair = triangulate_multi


def _unit(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + eps)


def triangulate_lines_pair(
    intr: Intrinsics,
    p0_a: torch.Tensor,  # (C, 2) segment endpoints of KF a (new keyframe)
    p1_a: torch.Tensor,
    desc_a: torch.Tensor,  # (C, D) float band descriptors
    cand_a: torch.Tensor,  # (C,) landmark-less detected segments
    p0_b: torch.Tensor,  # (C, 2) segments of neighbour KF b
    p1_b: torch.Tensor,
    desc_b: torch.Tensor,
    cand_b: torch.Tensor,
    T_ab: torch.Tensor,  # (4, 4) a-camera <- b-camera
    p0_c: torch.Tensor,  # (C, 2) third-view segments for verification
    p1_c: torch.Tensor,
    seg_c: torch.Tensor,  # (C,) third view has a detected segment
    T_ca: torch.Tensor,  # (4, 4) c-camera <- a-camera
    max_desc_dist: float = 0.45,
    max_angle: float = 0.15,
) -> LineTriangulationResult:
    """Two-view line triangulation with third-view consistency: descriptor
    matches under a rotation-warped direction gate, each matched pair's 3D
    line as the intersection of the two back-projected planes (a's endpoint
    rays cut b's plane), accepted only where a third keyframe sees a
    collinear segment."""
    Kinv = _kinv(intr, p0_a.device)

    def rays(p):
        return _homog(p) @ Kinv.T  # (C, 3) unit-z rays

    r0a, r1a = rays(p0_a), rays(p1_a)
    r0b, r1b = rays(p0_b), rays(p1_b)
    # Back-projected plane normal per segment (through the camera centre).
    n_a = _unit(torch.linalg.cross(r0a, r1a, dim=-1), 1e-12)
    n_b = _unit(torch.linalg.cross(r0b, r1b, dim=-1), 1e-12)

    # Descriptor matches with a rotation-warped direction gate
    # (src/LSDmatcher.cpp:1155-1290).
    R_ab, t_ab = T_ab[:3, :3], T_ab[:3, 3]
    ua = _unit(r1a - r0a, 1e-9)
    ub = _unit((r1b - r0b) @ R_ab.T, 1e-9)
    cosd = torch.abs(ua @ ub.T)  # (Ca, Cb)
    mask = cand_a[:, None] & cand_b[None, :] & (cosd > torch.cos(torch.tensor(max_angle)))
    Di = torch.clamp((line_distance_matrix(desc_a, desc_b) * 1000).to(torch.int32), 0, 2000)
    b_of_a, best_d, _ = hamming.masked_best2(Di, mask, invalid=10_000)
    matched = (b_of_a >= 0) & (best_d <= int(max_desc_dist * 1000))
    jb = b_of_a

    # b's matched plane in a's frame: normal m = R_ab n_b through b's centre
    # t_ab; endpoint depths s from m . (s r - t_ab) = 0.
    m = n_b[jb] @ R_ab.T  # (C, 3)
    md = torch.sum(m * t_ab, dim=-1)
    s0 = md / (torch.sum(m * r0a, dim=-1) + 1e-12)
    s1 = md / (torch.sum(m * r1a, dim=-1) + 1e-12)
    X0 = s0[:, None] * r0a
    X1 = s1[:, None] * r1a

    # Degenerate when the two planes are near-parallel (no parallax).
    sin_pl = torch.linalg.norm(torch.linalg.cross(n_a, m, dim=-1), dim=-1)
    length = torch.linalg.norm(X1 - X0, dim=-1)
    ok = (
        matched
        & (sin_pl > 0.02)
        & (s0 > 0.2) & (s1 > 0.2) & (s0 < 12.0) & (s1 < 12.0)
        & (length > 0.05) & (length < 10.0)
        & torch.isfinite(X0).all(dim=1) & torch.isfinite(X1).all(dim=1)
    )

    # Third-view consistency: both projected endpoints near some detected
    # segment's infinite line in KF c, with an aligned direction.
    X0c = se3.transform(T_ca, X0)
    X1c = se3.transform(T_ca, X1)
    q0 = camera_ops.project(intr, X0c)
    q1 = camera_ops.project(intr, X1c)
    front_c = (X0c[:, 2] > 0.1) & (X1c[:, 2] > 0.1)
    dc = p1_c - p0_c
    lc = torch.linalg.norm(dc, dim=-1) + 1e-9
    uc = dc / lc[:, None]
    nc = torch.stack([-uc[:, 1], uc[:, 0]], dim=1)  # (Cc, 2)
    off = torch.sum(nc * p0_c, dim=-1)
    dist0 = torch.abs(q0 @ nc.T - off[None, :])  # (Ca, Cc)
    dist1 = torch.abs(q1 @ nc.T - off[None, :])
    uq = _unit(q1 - q0, 1e-9)
    cos_c = torch.abs(uq @ uc.T)
    support = (
        seg_c[None, :]
        & (dist0 < 3.0) & (dist1 < 3.0)
        & (cos_c > torch.cos(torch.tensor(max_angle)))
    )
    ok = ok & front_c & torch.any(support, dim=1)
    return LineTriangulationResult(X0, X1, torch.where(ok, b_of_a, torch.full_like(b_of_a, -1)), ok)
