"""Projection-window descriptor matching — the dense-array ORBmatcher.

Port of `hfvo_tpu.tracking.matcher.search_by_projection` (reference:
src/ORBmatcher.cc:45 `SearchByProjection`): one masked (L x N) Hamming
matrix per search — window, octave, view-cos and rotation-histogram gates —
then conflict resolution so each keypoint keeps only its best landmark. The
line searches `search_lines_by_projection` (src/LSDmatcher.cpp:709) and
`search_lines_f2f` (src/LSDmatcher.cpp:36-156) do the same over cosine
distances of band descriptors, quantized to thousandths.

The JAX package resolves conflicts with key-encoded (L x N) min-reductions,
a TPU workaround for serialized scatters. Here the same keys
(distance * L + slot) are reduced per keypoint with `scatter_reduce`; the
winner is still the smallest (distance, slot) key.

Every search also takes leading batch dims (S sequences, each against its
own map rows); a batch element's keys and scatters stay within it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import camera, se3
from ..geometry.camera import Intrinsics
from ..ops import hamming
from ..ops.lines import line_distance_matrix

INF_KEY = 2**30


class ProjMatchResult(NamedTuple):
    pt_id_per_kp: torch.Tensor  # (*B, N) int64 landmark row per keypoint (-1 none)
    n_matches: torch.Tensor  # (*B,) int64
    visible: torch.Tensor  # (*B, L) bool landmark projected into the image


def _min_key_per_kp(kp: torch.Tensor, key: torch.Tensor, n_kp: int) -> torch.Tensor:
    """(*B, n_kp) minimum of `key` (*B, L) over the landmarks assigned to
    each keypoint by `kp` (*B, L) (INF_KEY where none)."""
    out = torch.full(key.shape[:-1] + (n_kp,), INF_KEY, dtype=key.dtype, device=key.device)
    return out.scatter_reduce(-1, kp, key, reduce="amin")


def search_by_projection(
    map_X: torch.Tensor,  # (L, 3) world points
    map_desc: torch.Tensor,  # (L, 8)
    map_valid: torch.Tensor,  # (L,)
    map_ids: torch.Tensor,  # (L,) ids to report back (arange for local rows)
    map_octave: torch.Tensor,  # (L,)
    kp_uv: torch.Tensor,  # (N, 2)
    kp_desc: torch.Tensor,  # (N, 8)
    kp_octave: torch.Tensor,  # (N,)
    kp_valid: torch.Tensor,  # (N,)
    T_cw: torch.Tensor,
    intr: Intrinsics,
    radius: float = 15.0,
    max_hamming: int = 80,
    check_octave: bool = True,
    map_angle: Optional[torch.Tensor] = None,  # (L,) creation-keypoint IC angle
    kp_angle: Optional[torch.Tensor] = None,  # (N,)
    map_normal: Optional[torch.Tensor] = None,  # (L, 3) mean viewing direction
    view_cos_limit: float = 0.5,
) -> ProjMatchResult:
    """Match projected landmarks to frame keypoints in a search window.

    The window radius scales with the keypoint octave (r * 1.2^octave,
    src/ORBmatcher.cc:87-94). With angles, matches must fall in the 3
    fullest bins of the 30-bin angle-difference histogram
    (src/ORBmatcher.cc:37-39,1632). With normals, a point seen from more than
    acos(view_cos_limit) away is rejected (src/Frame.cc:1371-1427); points
    with a zero normal pass. Batched, T_cw is (*B, 4, 4) and every other
    array gets the same leading dims."""
    L = map_X.shape[-2]
    N = kp_uv.shape[-2]
    X_c = se3.transform(T_cw[..., None, :, :], map_X)
    z = X_c[..., 2]
    proj = camera.project(intr, X_c)
    visible = map_valid & (z > 0.1) & camera.in_image(intr, proj, margin=1.0)
    if map_normal is not None:
        R, t = T_cw[..., :3, :3], T_cw[..., :3, 3:]
        O_w = -(R.transpose(-1, -2) @ t)[..., 0]
        view = map_X - O_w[..., None, :]
        view = view / (torch.linalg.norm(view, dim=-1, keepdim=True) + 1e-9)
        cos_v = torch.sum(view * map_normal, dim=-1)
        has_n = torch.sum(map_normal * map_normal, dim=-1) > 0.25
        visible = visible & (~has_n | (cos_v > view_cos_limit))

    r_per_kp = radius * torch.pow(
        torch.tensor(1.2, dtype=torch.float32, device=kp_uv.device), kp_octave.float()
    )[..., None, :]
    du = torch.abs(proj[..., :, 0:1] - kp_uv[..., None, :, 0])  # (*B, L, N)
    dv = torch.abs(proj[..., :, 1:2] - kp_uv[..., None, :, 1])
    mask = visible[..., :, None] & kp_valid[..., None, :] & (du <= r_per_kp) & (dv <= r_per_kp)
    if check_octave:
        mask = mask & (torch.abs(map_octave[..., :, None] - kp_octave[..., None, :]) <= 1)

    dist = hamming.hamming_matrix_f(map_desc, kp_desc)  # (*B, L, N)
    best_kp, best_d, _ = hamming.masked_best2(dist, mask)
    matched = best_d <= max_hamming

    slots = torch.arange(L, dtype=torch.int64, device=map_X.device)
    key = torch.where(matched, best_d.long() * L + slots, torch.full_like(best_kp, INF_KEY))
    keep = matched & (key == torch.gather(_min_key_per_kp(best_kp, key, N), -1, best_kp))

    if map_angle is not None and kp_angle is not None:
        keep = keep & hamming.rotation_consistency_mask(
            torch.gather(kp_angle, -1, best_kp), map_angle, keep)

    kmin2 = _min_key_per_kp(best_kp, torch.where(keep, key, torch.full_like(key, INF_KEY)), N)
    has = kmin2 < INF_KEY
    winner = torch.remainder(kmin2, L)
    ids = torch.gather(map_ids.expand(winner.shape[:-1] + (L,)), -1, winner)
    pt_per_kp = torch.where(has, ids, torch.full_like(kmin2, -1))
    return ProjMatchResult(pt_per_kp, torch.sum(pt_per_kp >= 0, dim=-1), visible)


def _quantized_desc_dist(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Cosine distance as an integer in [0, 2000] (thousandths, truncated)."""
    D = line_distance_matrix(desc_a, desc_b)
    return torch.clamp((D * 1000).to(torch.int32), 0, 2000).long()


def _index_per_target(src_ok: torch.Tensor, target: torch.Tensor, n_target: int) -> torch.Tensor:
    """(*B, n_target) source index per target (-1 none) for the sources
    (*B, P) with src_ok; each target has at most one. The sources without
    src_ok write to a spare column past the end, which is dropped."""
    out = torch.full(target.shape[:-1] + (n_target + 1,), -1, dtype=torch.int64,
                     device=target.device)
    src = torch.arange(src_ok.shape[-1], device=target.device).expand(target.shape)
    out.scatter_(-1, torch.where(src_ok, target, n_target), torch.where(src_ok, src, -1))
    return out[..., :n_target]


def _angle_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| wrapped into [0, pi] (floor-mod, as jnp's %)."""
    return torch.abs(torch.remainder((a - b) + torch.pi, 2 * torch.pi) - torch.pi)


def search_lines_by_projection(
    ml_X0: torch.Tensor,  # (L, 3) map line endpoints (world)
    ml_X1: torch.Tensor,
    ml_desc: torch.Tensor,  # (L, D) float band descriptors
    ml_valid: torch.Tensor,  # (L,)
    ln_p0: torch.Tensor,  # (M, 2) detected segments
    ln_p1: torch.Tensor,
    ln_desc: torch.Tensor,  # (M, D)
    ln_valid: torch.Tensor,
    T_cw: torch.Tensor,
    intr: Intrinsics,
    radius: float = 30.0,
    max_desc_dist: float = 0.5,
    max_angle: float = 0.2,
) -> ProjMatchResult:
    """Match projected map lines to detected segments (reference:
    LSDmatcher::SearchByProjection, src/LSDmatcher.cpp:709): both 3D
    endpoints projected; gates on the detected midpoint's perpendicular
    distance to the projected infinite line, along-line overlap with a
    40 px margin, the directional angle (segments are canonically oriented)
    and the band-descriptor distance; each segment keeps the map line with
    the smallest (distance, row) key. Returns the map row per segment."""
    L = ml_X0.shape[-2]
    M = ln_p0.shape[-2]
    dev = ml_X0.device
    Q0c = se3.transform(T_cw[..., None, :, :], ml_X0)
    Q1c = se3.transform(T_cw[..., None, :, :], ml_X1)
    q0 = camera.project(intr, Q0c)
    q1 = camera.project(intr, Q1c)
    vis = ml_valid & (Q0c[..., 2] > 0.1) & (Q1c[..., 2] > 0.1)
    dir_m = q1 - q0
    len_m = torch.linalg.norm(dir_m, dim=-1) + 1e-9
    u_m = dir_m / len_m[..., None]
    ang_m = torch.atan2(dir_m[..., 1], dir_m[..., 0])
    mid_f = 0.5 * (ln_p0 + ln_p1)
    dir_f = ln_p1 - ln_p0
    ang_f = torch.atan2(dir_f[..., 1], dir_f[..., 0])
    n_m = torch.stack([-u_m[..., 1], u_m[..., 0]], dim=-1)
    rel = mid_f[..., None, :, :] - q0[..., :, None, :]  # (*B, L, M, 2)
    d_perp = torch.abs(torch.einsum("...lmc,...lc->...lm", rel, n_m))
    t_along = torch.einsum("...lmc,...lc->...lm", rel, u_m)
    margin = 40.0
    overlap = (t_along > -margin) & (t_along < len_m[..., None] + margin)
    da = _angle_diff(ang_m[..., :, None], ang_f[..., None, :])
    mask = (
        vis[..., :, None] & ln_valid[..., None, :]
        & (d_perp < radius) & overlap & (da < max_angle)
    )
    Di = _quantized_desc_dist(ml_desc, ln_desc)
    best_f, best_d, _ = hamming.masked_best2(Di, mask, invalid=10_000)
    matched = best_d <= int(max_desc_dist * 1000)
    rows = torch.arange(L, device=dev)
    key = torch.where(matched, best_d * L + rows, torch.full_like(best_f, INF_KEY))
    keep = matched & (key == torch.gather(_min_key_per_kp(best_f, key, M), -1, best_f))
    per_f = _index_per_target(keep, best_f, M)
    return ProjMatchResult(per_f, torch.sum(per_f >= 0, dim=-1), vis)


def search_lines_f2f(
    w0: torch.Tensor,  # (P, 2) previous segments' endpoints, rotation-warped
    w1: torch.Tensor,  # into the current view (K R_cl K^-1)
    prev_desc: torch.Tensor,  # (P, D)
    prev_valid: torch.Tensor,  # (P,)
    ln_p0: torch.Tensor,  # (C, 2) current detections
    ln_p1: torch.Tensor,
    ln_desc: torch.Tensor,  # (C, D)
    ln_valid: torch.Tensor,
    max_desc_dist: float = 0.5,
    max_mid_dist: float = 40.0,
    max_angle: float = 0.2,
) -> ProjMatchResult:
    """Frame-to-frame line matching by descriptor + warped geometry
    (reference: LSDmatcher::SearchByGeomNApearance, src/LSDmatcher.cpp:36-156):
    mutual best under midpoint-distance, angle and band-descriptor gates.
    Returns the previous-segment index per current segment (-1 = none)."""
    P = w0.shape[-2]
    C = ln_p0.shape[-2]
    mid_p = 0.5 * (w0 + w1)
    dir_p = w1 - w0
    ang_p = torch.atan2(dir_p[..., 1], dir_p[..., 0])
    mid_c = 0.5 * (ln_p0 + ln_p1)
    dir_c = ln_p1 - ln_p0
    ang_c = torch.atan2(dir_c[..., 1], dir_c[..., 0])
    dmid = torch.linalg.norm(mid_p[..., :, None, :] - mid_c[..., None, :, :], dim=-1)
    da = _angle_diff(ang_p[..., :, None], ang_c[..., None, :])
    mask = (
        prev_valid[..., :, None] & ln_valid[..., None, :]
        & (dmid < max_mid_dist) & (da < max_angle)
    )
    Di = _quantized_desc_dist(prev_desc, ln_desc)
    best_c, best_d, _ = hamming.masked_best2(Di, mask, invalid=10_000)
    ok_p = best_d <= int(max_desc_dist * 1000)
    # Mutual: the chosen current segment's best previous segment must agree.
    best_p = torch.argmin(torch.where(mask, Di, torch.full_like(Di, 10_000)), dim=-2)
    ok_p = ok_p & (torch.gather(best_p, -1, best_c) == torch.arange(P, device=w0.device))
    per_c = _index_per_target(ok_p, best_c, C)
    return ProjMatchResult(per_c, torch.sum(per_c >= 0, dim=-1), prev_valid)
