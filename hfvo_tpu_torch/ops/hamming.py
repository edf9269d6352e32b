"""Hamming distance between packed 256-bit ORB descriptors.

Port of `hfvo_tpu.ops.hamming` (reference: src/ORBmatcher.cc:1669-1693
`DescriptorDistance`). The distance matrix is a float32 ±1 matmul,
`dist = (256 - A @ B^T) / 2`: the inputs and every partial sum are small
integers, so it is exact in float32 (TF32 is off package-wide).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

MAX_DIST = 256


@functools.lru_cache(maxsize=None)
def _shifts_on(device: str) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(*B, N, 8) int64 words -> (*B, N, 256) float32 in {0, 1}."""
    shifts = _shifts_on(str(desc.device))
    bits = (desc[..., None] >> shifts) & 1
    return bits.reshape(desc.shape[:-1] + (256,)).float()


def hamming_matrix_f(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances (*B, N1, N2) as exact integer-valued float32."""
    a = unpack_bits(desc_a) * 2.0 - 1.0
    b = unpack_bits(desc_b) * 2.0 - 1.0
    return (MAX_DIST - a @ b.transpose(-1, -2)) * 0.5


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances (*B, N1, N2) int32."""
    return hamming_matrix_f(desc_a, desc_b).to(torch.int32)


def hamming_pairs(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance of aligned rows: (*B, N, 8), (*B, N, 8)
    -> (*B, N) int32."""
    x = torch.bitwise_xor(desc_a, desc_b)
    return ((x[..., None] >> _shifts_on(str(x.device))) & 1).sum(dim=(-2, -1)).to(torch.int32)


def mutual_best(
    dist: torch.Tensor, mask: torch.Tensor, invalid: int = MAX_DIST + 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mutual nearest-neighbour matches along the last two axes of
    (*B, N1, N2): (idx_b (*B, N1) int64, ok (*B, N1)). Ties go to the lowest
    index (`torch.argmin` returns the first minimum), as `jnp.argmin` does."""
    d = torch.where(mask, dist, torch.full_like(dist, invalid))
    best_b = torch.argmin(d, dim=-1)
    best_a = torch.argmin(d, dim=-2)
    rows = torch.arange(d.shape[-2], device=d.device)
    ok = torch.gather(best_a, -1, best_b) == rows
    ok = ok & (torch.gather(d, -1, best_b[..., None])[..., 0] <= MAX_DIST)
    return best_b, ok


def masked_best2(
    dist: torch.Tensor, mask: torch.Tensor, invalid: int = MAX_DIST + 1
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best and second-best along the last axis under a boolean mask.

    Returns (best_idx (*B, N1), best_dist, second_dist); masked-out
    entries read as `invalid`. The smallest column wins ties (`torch.min`
    returns the first minimum), and the second best excludes the best
    COLUMN, so a duplicate of the best value elsewhere still counts — the
    semantics of the JAX package's key-encoded reductions."""
    d = torch.where(mask, dist, torch.full_like(dist, invalid))
    best_d, best_idx = torch.min(d, dim=-1)
    excl = d.scatter(-1, best_idx[..., None], float(invalid))
    second = torch.min(excl, dim=-1).values
    return best_idx, best_d, second


def rotation_consistency_mask(
    angle_a: torch.Tensor,
    angle_b_matched: torch.Tensor,
    match_ok: torch.Tensor,
    n_bins: int = 30,
    keep_top: int = 3,
) -> torch.Tensor:
    """Keep matches whose angle difference falls in the `keep_top` most
    populated histogram bins (reference: src/ORBmatcher.cc rotation
    histogram, HISTO_LENGTH=30, ComputeThreeMaxima :1632), one histogram
    per batch element of (*B, N). Tied bin counts rank in bin order, as
    `jax.lax.top_k` ranks them."""
    two_pi = 2.0 * torch.pi
    rot = torch.remainder(angle_a - angle_b_matched, two_pi)
    bin_idx = torch.clamp((rot * n_bins / two_pi).to(torch.int64), 0, n_bins - 1)
    hist = torch.zeros(bin_idx.shape[:-1] + (n_bins,), dtype=torch.int64, device=angle_a.device)
    hist = hist.scatter_add(-1, bin_idx, match_ok.long())
    top_bins = torch.sort(hist, dim=-1, descending=True, stable=True).indices[..., :keep_top]
    in_top = (bin_idx[..., :, None] == top_bins[..., None, :]).any(dim=-1)
    return match_ok & in_top
