"""ORB keypoint orientation + steered-BRIEF descriptors, batched over keypoints.

Port of `hfvo_tpu.ops.orb` (reference: src/ORBextractor.cc `IC_Angle` :77,
`computeOrbDescriptor` :105, `operator()` :1041). The BRIEF pattern and the
32 rotation bins are built with the JAX package's recipe
(`np.random.RandomState(42)`), so both packages sample the same pairs.

The JAX package evaluates steered BRIEF as a matmul against a bank of
{-1, 0, +1} difference matrices (`BIN_DIFF_MATS`), a TPU lowering choice.
Here each keypoint gathers its bin's 256 rotated sample pairs directly; each
bank column holds exactly one +1 and one -1, so `v2 - v1` and the bits are
the same.

Descriptors are (N, 8) int64 tensors, each holding one 32-bit word
(bit j of word k = bit 32k+j), the values of the JAX package's uint32 words.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple

import numpy as np
import torch

from ..config import OrbConfig
from . import fast as fast_ops
from .image import build_pyramid, extract_patches, gaussian_blur

PATCH_R = 15  # orientation patch radius (31x31), reference HALF_PATCH_SIZE
_PATTERN_R = 13  # BRIEF sample points live in a radius-13 disk
_SIDE = 2 * PATCH_R + 1


def _make_pattern(seed: int = 42, n_bits: int = 256) -> np.ndarray:
    """(n_bits, 4) float32 of (x1, y1, x2, y2) BRIEF sample offsets."""
    rs = np.random.RandomState(seed)
    pts = []
    while len(pts) < n_bits:
        p = rs.normal(0.0, PATCH_R * 2 / 5.0, size=4)
        if np.hypot(p[0], p[1]) <= _PATTERN_R and np.hypot(p[2], p[3]) <= _PATTERN_R:
            pts.append(p)
    return np.asarray(pts, dtype=np.float32)


BRIEF_PATTERN = _make_pattern()

N_ANGLE_BINS = 32


def _make_bin_pair_index() -> np.ndarray:
    """(N_ANGLE_BINS, 256, 2) int64 flat patch indices (point 1, point 2)
    of every BRIEF pair under each quantized rotation (round to the nearest
    pixel, clip to the patch)."""
    out = np.zeros((N_ANGLE_BINS, 256, 2), np.int64)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        x1 = BRIEF_PATTERN[:, 0] * ca - BRIEF_PATTERN[:, 1] * sa
        y1 = BRIEF_PATTERN[:, 0] * sa + BRIEF_PATTERN[:, 1] * ca
        x2 = BRIEF_PATTERN[:, 2] * ca - BRIEF_PATTERN[:, 3] * sa
        y2 = BRIEF_PATTERN[:, 2] * sa + BRIEF_PATTERN[:, 3] * ca
        ix1 = np.clip(np.round(x1).astype(int) + PATCH_R, 0, _SIDE - 1)
        iy1 = np.clip(np.round(y1).astype(int) + PATCH_R, 0, _SIDE - 1)
        ix2 = np.clip(np.round(x2).astype(int) + PATCH_R, 0, _SIDE - 1)
        iy2 = np.clip(np.round(y2).astype(int) + PATCH_R, 0, _SIDE - 1)
        out[b, :, 0] = iy1 * _SIDE + ix1
        out[b, :, 1] = iy2 * _SIDE + ix2
    return out


BIN_PAIR_INDEX = _make_bin_pair_index()


def bin_diff_mats() -> np.ndarray:
    """The JAX package's `BIN_DIFF_MATS` (N_ANGLE_BINS, 961, 256) float32,
    rebuilt from `BIN_PAIR_INDEX` with its recipe (+1 at point 2, -1 at
    point 1 per column). Only the table check in `convert` needs it."""
    out = np.zeros((N_ANGLE_BINS, _SIDE * _SIDE, 256), np.float32)
    j = np.arange(256)
    for b in range(N_ANGLE_BINS):
        np.add.at(out[b], (BIN_PAIR_INDEX[b, :, 1], j), 1.0)
        np.add.at(out[b], (BIN_PAIR_INDEX[b, :, 0], j), -1.0)
    return out


# Circular mask for the intensity-centroid moment patch.
_yy, _xx = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1]
CIRC_MASK = (_yy**2 + _xx**2 <= PATCH_R**2).astype(np.float32)
MOMENT_X = (_xx * CIRC_MASK).astype(np.float32)
MOMENT_Y = (_yy * CIRC_MASK).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _consts_on(device: str):
    return (
        torch.from_numpy(MOMENT_X).to(device),
        torch.from_numpy(MOMENT_Y).to(device),
        torch.from_numpy(BIN_PAIR_INDEX).to(device),
        torch.arange(32, dtype=torch.int64, device=device),
    )


def ic_angles_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (radians) from (*B, N, 31, 31) patches."""
    mx, my, _, _ = _consts_on(str(patches.device))
    m10 = torch.sum(patches * mx, dim=(-2, -1))
    m01 = torch.sum(patches * my, dim=(-2, -1))
    return torch.atan2(m01, m10)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(*B, 256) {0, 1} -> (*B, 8) int64 words (bit j of word k = bit 32k+j)."""
    shifts = _consts_on(str(bits.device))[3]
    return torch.sum(bits.long().reshape(bits.shape[:-1] + (8, 32)) << shifts, dim=-1)


def brief_from_patches(patches: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Steered-BRIEF 256-bit descriptors -> (*B, N, 8) int64 words from
    (*B, N, 31, 31) patches. The keypoint angle selects one of N_ANGLE_BINS
    rotated patterns (the ORB paper's lookup-table discretization)."""
    pair_idx = _consts_on(str(patches.device))[2]
    flat = patches.reshape(patches.shape[:-2] + (-1,))  # (*B, N, 961)
    bins = torch.remainder(
        torch.round(angles * (N_ANGLE_BINS / (2.0 * np.pi))).long(), N_ANGLE_BINS
    )
    idx = pair_idx[bins]  # (*B, N, 256, 2)
    v1 = torch.gather(flat, -1, idx[..., 0])
    v2 = torch.gather(flat, -1, idx[..., 1])
    return pack_bits(v2 - v1 > 0)


class OrbFeatures(NamedTuple):
    """Fixed-capacity per-frame ORB features (level-0 pixel coordinates)."""

    uv: torch.Tensor  # (*B, N, 2) float32, (x, y) at level-0 scale
    response: torch.Tensor  # (N,)
    angle: torch.Tensor  # (N,) radians
    octave: torch.Tensor  # (N,) int64
    desc: torch.Tensor  # (N, 8) int64 words
    valid: torch.Tensor  # (N,) bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[-2]


def level_budgets(n_features: int, n_levels: int, scale: float) -> List[int]:
    """Per-level keypoint budgets, geometric like the reference
    (src/ORBextractor.cc:448-470)."""
    inv = 1.0 / scale
    raw = np.array([inv**l for l in range(n_levels)])
    b = np.floor(n_features * raw / raw.sum()).astype(int)
    b[-1] = max(n_features - int(b[:-1].sum()), 0)
    return [int(x) for x in b]


def _fit(t: torch.Tensor, capacity: int, dim: int) -> torch.Tensor:
    """Trim or zero-pad dim `dim` of t to `capacity`."""
    n = t.shape[dim]
    if n >= capacity:
        return t.narrow(dim, 0, capacity)
    shape = list(t.shape)
    shape[dim] = capacity - n
    return torch.cat([t, torch.zeros(shape, dtype=t.dtype, device=t.device)], dim=dim)


def extract_orb(img: torch.Tensor, cfg: OrbConfig, capacity: int) -> OrbFeatures:
    """Full ORB extraction over the pyramid into fixed-capacity tensors.

    img: (*B, H, W) float32 grayscale in [0, 255]; the features get the
    same leading dims."""
    batch = img.shape[:-2]
    pyr = build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    budgets = level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    uvs, resps, angs, octs, descs, valids = [], [], [], [], [], []
    for l, (img_l, budget) in enumerate(zip(pyr, budgets)):
        if budget == 0:
            continue
        yx, resp, valid = fast_ops.detect_grid_topk(
            img_l.contiguous(),
            float(cfg.ini_th_fast),
            float(cfg.min_th_fast),
            cfg.grid_cell,
            budget,
            cfg.edge_threshold,
        )
        # One patch extraction per level serves both the orientation and the
        # descriptor, on the blurred level (as in the JAX package).
        patches = extract_patches(gaussian_blur(img_l, 2.0, 3), yx, PATCH_R)
        ang = ic_angles_from_patches(patches)
        desc = brief_from_patches(patches, ang)
        # Level-l pixel centers -> level-0 coordinates with the actual
        # per-level scale and the half-pixel offset of the resize.
        h_l, w_l = img_l.shape[-2:]
        sx = img.shape[-1] / w_l
        sy = img.shape[-2] / h_l
        u = (yx[..., 1].float() + 0.5) * sx - 0.5
        v = (yx[..., 0].float() + 0.5) * sy - 0.5
        uvs.append(torch.stack([u, v], dim=-1))
        resps.append(resp)
        angs.append(ang)
        octs.append(torch.full(batch + (budget,), l, dtype=torch.int64, device=img.device))
        descs.append(desc)
        valids.append(valid)
    nb = len(batch)
    return OrbFeatures(*(
        _fit(torch.cat(parts, dim=nb), capacity, nb)
        for parts in (uvs, resps, angs, octs, descs, valids)
    ))
