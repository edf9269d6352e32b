"""Projection-window descriptor matching — the dense-array ORBmatcher.

Port of `hfvo_tpu.tracking.matcher.search_by_projection` (reference:
src/ORBmatcher.cc:45 `SearchByProjection`): one masked (L x N) Hamming
matrix per search — window, octave, view-cos and rotation-histogram gates —
then conflict resolution so each keypoint keeps only its best landmark.

The JAX package resolves conflicts with key-encoded (L x N) min-reductions,
a TPU workaround for serialized scatters. Here the same keys
(distance * L + slot) are reduced per keypoint with `scatter_reduce`; the
winner is still the smallest (distance, slot) key.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import camera, se3
from ..geometry.camera import Intrinsics
from ..ops import hamming

INF_KEY = 2**30


class ProjMatchResult(NamedTuple):
    pt_id_per_kp: torch.Tensor  # (N,) int64 landmark row per keypoint (-1 none)
    n_matches: torch.Tensor  # scalar int64
    visible: torch.Tensor  # (L,) bool landmark projected into the image


def _min_key_per_kp(kp: torch.Tensor, key: torch.Tensor, n_kp: int) -> torch.Tensor:
    """(n_kp,) minimum of `key` over the landmarks assigned to each keypoint
    (INF_KEY where none)."""
    out = torch.full((n_kp,), INF_KEY, dtype=key.dtype, device=key.device)
    return out.scatter_reduce(0, kp, key, reduce="amin")


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
    with a zero normal pass."""
    L = map_X.shape[0]
    N = kp_uv.shape[0]
    X_c = se3.transform(T_cw, map_X)
    z = X_c[:, 2]
    proj = camera.project(intr, X_c)
    visible = map_valid & (z > 0.1) & camera.in_image(intr, proj, margin=1.0)
    if map_normal is not None:
        O_w = -T_cw[:3, :3].T @ T_cw[:3, 3]
        view = map_X - O_w
        view = view / (torch.linalg.norm(view, dim=1, keepdim=True) + 1e-9)
        cos_v = torch.sum(view * map_normal, dim=1)
        has_n = torch.sum(map_normal * map_normal, dim=1) > 0.25
        visible = visible & (~has_n | (cos_v > view_cos_limit))

    r_per_kp = radius * torch.pow(
        torch.tensor(1.2, dtype=torch.float32, device=kp_uv.device), kp_octave.float()
    )
    du = torch.abs(proj[:, 0:1] - kp_uv[None, :, 0])  # (L, N)
    dv = torch.abs(proj[:, 1:2] - kp_uv[None, :, 1])
    mask = visible[:, None] & kp_valid[None, :] & (du <= r_per_kp) & (dv <= r_per_kp)
    if check_octave:
        mask = mask & (torch.abs(map_octave[:, None] - kp_octave[None, :]) <= 1)

    dist = hamming.hamming_matrix_f(map_desc, kp_desc)  # (L, N)
    best_kp, best_d, _ = hamming.masked_best2(dist, mask)
    matched = best_d <= max_hamming

    slots = torch.arange(L, dtype=torch.int64, device=map_X.device)
    key = torch.where(matched, best_d.long() * L + slots, torch.full_like(slots, INF_KEY))
    keep = matched & (key == _min_key_per_kp(best_kp, key, N)[best_kp])

    if map_angle is not None and kp_angle is not None:
        keep = keep & hamming.rotation_consistency_mask(kp_angle[best_kp], map_angle, keep)

    kmin2 = _min_key_per_kp(best_kp, torch.where(keep, key, torch.full_like(key, INF_KEY)), N)
    has = kmin2 < INF_KEY
    winner = torch.remainder(kmin2, L)
    pt_per_kp = torch.where(has, map_ids[winner], torch.full_like(kmin2, -1))
    return ProjMatchResult(pt_per_kp, torch.sum(pt_per_kp >= 0), visible)
