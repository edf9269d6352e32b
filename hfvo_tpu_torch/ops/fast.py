"""FAST-9/16 corner detection as a dense, branch-free array program.

Port of `hfvo_tpu.ops.fast`. The whole image is scored at both thresholds
in one pass; high-threshold corners get a large bonus so the budgeted
selection prefers strong corners but falls back to weak ones in empty
regions (the intent of the reference's per-cell 20 -> 7 retry,
src/ORBextractor.cc:770-860).

`fast_score_dual_levels` owns kernel K1 and its batched launch K1b, and
`fast_score_levels` kernel K2 and its batched launch K2b: one source,
`csrc/fast_dual.cu` (the port of `hfvo_tpu/ops/pallas_fast.py::_kernel_dual`
and `::_kernel`), with the threshold count a template parameter and one C
entry point. A call scores a list of levels (a pyramid) in one launch for
every 16 levels; (H, W) levels are K1 or K2, (S, H, W) stacks K1b or K2b.
`fast_score_dual` and `fast_score` are the one-level case. A CPU list takes
the plain version level by level; a CUDA list launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .image import build_pyramid, gaussian_blur, maxpool2d_same, sobel_gradients

# Bresenham circle of radius 3, 16 points, clockwise from 12 o'clock, as
# (dy, dx) offsets.
CIRCLE_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # FAST-9

# Kernel launches, one per 16 levels of a CUDA list whatever S is:
# K1 and K2 on (H, W) levels, K1b and K2b on (S, H, W) stacks. Read and
# reset by callers that check a path used them.
fast_dual_launches = 0  # K1
fast_dual_batched_launches = 0  # K1b
fast_score_launches = 0  # K2
fast_score_batched_launches = 0  # K2b

MAX_LEVELS = 16  # levels one launch takes (csrc/fast_dual.cu MAX_LEVELS)


class _Level(ctypes.Structure):
    """csrc/fast_dual.cu's HfvoFastLevel: one level of the table."""

    _fields_ = [("img", ctypes.c_void_p), ("out", ctypes.c_void_p), ("h", ctypes.c_int),
                ("w", ctypes.c_int)]


# C interface of csrc/fast_dual.cu: (levels, n_levels, S, thresholds count,
# th_low, th_high, bonus, stream) -> cudaError_t.
_FAST_SIGNATURES = {
    "hfvo_fast_score_levels": (
        ctypes.c_int,
        [ctypes.POINTER(_Level), ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
    ),
}


def _interior(h: int, w: int, device) -> torch.Tensor:
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)


def _contiguous_arc(bits: torch.Tensor) -> torch.Tensor:
    """True where the 16 ring flags packed in the low bits of `bits` (int32)
    hold a circular run of ARC_LEN = 9: double the mask to 32 bits, then
    r &= r >> 1, >> 2, >> 4 (runs of 8) and >> 1 once more (runs of 9).
    Bits 24 and up never reach the low 16, so the sign fill is harmless."""
    x = bits | (bits << 16)
    x = x & (x >> 1)
    x = x & (x >> 2)
    x = x & (x >> 4)
    x = x & (x >> 1)
    return (x & 0xFFFF) != 0


def _fast_scores(img: torch.Tensor, thresholds) -> list:
    """`fast_score` at each threshold, sharing one set of ring views;
    img is (*B, H, W)."""
    h, w = img.shape[-2:]
    padded = torch.nn.functional.pad(img, (3, 3, 3, 3))
    rings = [padded[..., 3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in CIRCLE_OFFSETS]
    zero = torch.zeros_like(img)
    interior = _interior(h, w, img.device)
    out = []
    for th in thresholds:
        hi = img + th
        lo = img - th
        bright_bits = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
        dark_bits = torch.zeros_like(bright_bits)
        bright_s = zero
        dark_s = zero
        for k, r in enumerate(rings):
            b = r > hi
            d = r < lo
            bright_bits = bright_bits | (b.to(torch.int32) << k)
            dark_bits = dark_bits | (d.to(torch.int32) << k)
            bright_s = bright_s + torch.where(b, r - img - th, zero)
            dark_s = dark_s + torch.where(d, lo - r, zero)
        corner = _contiguous_arc(bright_bits) | _contiguous_arc(dark_bits)
        out.append(torch.where(corner & interior, torch.maximum(bright_s, dark_s), zero))
    return out


def fast_score_reference(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Plain version of kernel K2: the dense FAST-9/16 response map
    (*B, H, W); zero where not a corner or within 3 px of the border.

    The arc-strength sums accumulate in ring order k = 0..15, the order of
    the TPU kernel's `_fast_score_tile` and of the CUDA kernel."""
    return _fast_scores(img, [threshold])[0]


def fast_score_dual_reference(
    img: torch.Tensor, th_low: float, th_high: float, bonus: float = 1e4
) -> torch.Tensor:
    """Plain version of kernel K1: `where(s_high > 0, s_high + bonus, s_low)`
    for `s_* = fast_score(img, th_*)` (hfvo_tpu/ops/fast.py:127-129), on
    (*B, H, W)."""
    s_low, s_high = _fast_scores(img, [th_low, th_high])
    return torch.where(s_high > 0, s_high + bonus, s_low)


def fast_candidates_reference(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Plain mirror of the kernels' exact early-reject test on (*B, H, W):
    True inside the 3-px border where ring pixels 0 or 8, and 4 or 12, are
    all bright (r > c + threshold) or all dark (r < c - threshold). Every
    9-arc of the ring holds one of {0, 8} and one of {4, 12}, so every
    corner at `threshold` or above passes."""
    h, w = img.shape[-2:]
    padded = torch.nn.functional.pad(img, (3, 3, 3, 3))
    r0, r4, r8, r12 = (padded[..., 3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w]
                       for dy, dx in CIRCLE_OFFSETS[[0, 4, 8, 12]])
    hi, lo = img + threshold, img - threshold
    bright = ((r0 > hi) | (r8 > hi)) & ((r4 > hi) | (r12 > hi))
    dark = ((r0 < lo) | (r8 < lo)) & ((r4 < lo) | (r12 < lo))
    return (bright | dark) & _interior(h, w, img.device)


def _check_levels(name: str, levels: Sequence[torch.Tensor]) -> Optional[torch.device]:
    """The one device of a list the kernel can take (None for an empty
    list); raises ValueError otherwise (before anything launches)."""
    if not levels:
        return None
    dev = levels[0].device
    if any(x.device != dev for x in levels):
        raise ValueError(f"{name}: levels on more than one device {sorted({str(x.device) for x in levels})}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    lead = levels[0].shape[:-2]
    for x in levels:
        if x.dim() < 2 or x.shape[:-2] != lead:
            raise ValueError(f"{name}: levels need the same leading dims, got {[tuple(x.shape) for x in levels]}")
        if dev.type == "cuda" and (x.dtype != torch.float32 or x.dim() not in (2, 3)
                                   or not x.is_contiguous()):
            raise ValueError(f"{name}: needs contiguous (H, W) or (S, H, W) float32 levels, got "
                             f"{x.dtype} of shape {tuple(x.shape)}")
    return dev


def _launch_levels(levels: Sequence[torch.Tensor], n_th: int, th_low: float, th_high: float,
                   bonus: float, lib: Optional[ctypes.CDLL] = None) -> List[torch.Tensor]:
    """One launch of csrc/fast_dual.cu (or of `lib`, a library built from a
    variant of it) over up to MAX_LEVELS checked CUDA levels; raises on a
    failed launch."""
    from . import _kernels

    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"fast_dual: one launch takes 1 to {MAX_LEVELS} levels, got {len(levels)}")
    if lib is None:
        lib = _kernels.load("fast_dual", _FAST_SIGNATURES)
    outs = [torch.empty_like(x) for x in levels]
    table = (_Level * len(levels))(*(
        _Level(x.data_ptr(), o.data_ptr(), x.shape[-2], x.shape[-1]) for x, o in zip(levels, outs)
    ))
    s = levels[0].shape[0] if levels[0].dim() == 3 else 1
    dev = levels[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hfvo_fast_score_levels(table, len(levels), s, n_th, th_low, th_high, bonus,
                                         ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fast_dual kernel launch failed: {_kernels.error_string(lib, err)}")
    return outs


def _chunks(levels: Sequence[torch.Tensor]) -> List[Sequence[torch.Tensor]]:
    """The list cut into the kernel's tables of up to MAX_LEVELS levels."""
    return [levels[i : i + MAX_LEVELS] for i in range(0, len(levels), MAX_LEVELS)]


def fast_score_levels(levels: Sequence[torch.Tensor], threshold: float) -> List[torch.Tensor]:
    """Dense FAST-9/16 response map of every level (kernel K2 on (H, W)
    levels, K2b on (S, H, W) stacks), one launch for every 16 levels on one
    device with the same leading dims; see `fast_score_reference`. A CPU
    list goes to the plain version level by level."""
    global fast_score_launches, fast_score_batched_launches
    dev = _check_levels("fast_score_levels", levels)
    if dev is None or dev.type == "cpu":
        return [fast_score_reference(x, threshold) for x in levels]
    out = []
    for part in _chunks(levels):
        out += _launch_levels(part, 1, float(threshold), 0.0, 0.0)
        if levels[0].dim() == 3:
            fast_score_batched_launches += 1
        else:
            fast_score_launches += 1
    return out


def fast_score_dual_levels(
    levels: Sequence[torch.Tensor], th_low: float, th_high: float, bonus: float = 1e4
) -> List[torch.Tensor]:
    """Combined dual-threshold FAST priority map of every level (kernel K1
    on (H, W) levels, K1b on (S, H, W) stacks), one launch for every 16
    levels on one device with the same leading dims.

    Levels: float32, contiguous, in [0, 255]. A CPU list goes to
    `fast_score_dual_reference` level by level; a CUDA list to the kernel."""
    global fast_dual_launches, fast_dual_batched_launches
    dev = _check_levels("fast_score_dual_levels", levels)
    if dev is None or dev.type == "cpu":
        return [fast_score_dual_reference(x, th_low, th_high, bonus) for x in levels]
    out = []
    for part in _chunks(levels):
        out += _launch_levels(part, 2, float(th_low), float(th_high), float(bonus))
        if levels[0].dim() == 3:
            fast_dual_batched_launches += 1
        else:
            fast_dual_launches += 1
    return out


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """`fast_score_levels` on one level (K2 on (H, W), K2b on (S, H, W))."""
    return fast_score_levels([img], threshold)[0]


def fast_score_dual(
    img: torch.Tensor, th_low: float, th_high: float, bonus: float = 1e4
) -> torch.Tensor:
    """`fast_score_dual_levels` on one level (K1 on (H, W), K1b on
    (S, H, W))."""
    return fast_score_dual_levels([img], th_low, th_high, bonus)[0]


def pyramid_fast_scores(
    img: torch.Tensor, th_low: float, th_high: float, n_levels: int = 8, scale: float = 1.2
) -> List[torch.Tensor]:
    """The image pyramid of img (*B, H, W) and `fast_score` at both
    thresholds on every level, [low_0, high_0, low_1, ...]: the JAX
    package's "pyramid + 2x fast_score all levels" probe
    (profile_step.py:147-158), the path that runs kernel K2 (K2b on a
    stack), one launch a threshold."""
    levels = [lvl.contiguous() for lvl in build_pyramid(img, n_levels, scale)]
    lows, highs = fast_score_levels(levels, th_low), fast_score_levels(levels, th_high)
    return [m for pair in zip(lows, highs) for m in pair]


def fast_nms(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression on a response map."""
    return torch.where(score >= maxpool2d_same(score, 3), score, torch.zeros_like(score))


def shi_tomasi_min_eig(img: torch.Tensor) -> torch.Tensor:
    """Min eigenvalue of the smoothed gradient structure tensor (edge-like
    responses have lambda_min ~ 0 and slide along the edge)."""
    gx, gy = sobel_gradients(img)
    sxx = gaussian_blur(gx * gx, 1.5, 2)
    syy = gaussian_blur(gy * gy, 1.5, 2)
    sxy = gaussian_blur(gx * gy, 1.5, 2)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = torch.sqrt(torch.clamp(tr * tr * 0.25 - det, min=0.0))
    return tr * 0.5 - disc


def detect_grid_topk(
    img: torch.Tensor,
    th_high: float,
    th_low: float,
    cell: int,
    n_keep: int,
    border: int,
    combined: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FAST keypoints with per-cell uniformity and a fixed budget.

    img: (*B, H, W). Returns (yx (*B, n_keep, 2) int64, response
    (*B, n_keep), valid (*B, n_keep)). Dual-threshold scoring, 3x3 NMS, a
    Shi-Tomasi edge gate, per-`cell` top-1 bucketing, then the global
    top-`n_keep` (the JAX package's replacement for the reference's
    quadtree, src/ORBextractor.cc:537).

    Ties: per-cell `argmax` takes the first maximum like `jnp.argmax`, and
    the global selection is a stable descending sort, which keeps tied
    scores in index order like `jax.lax.top_k`.

    `combined`: img's `fast_score_dual(img, th_low, th_high)` where the
    caller has it (`extract_orb` scores all levels in one launch); computed
    here when absent.
    """
    batch = img.shape[:-2]
    h, w = img.shape[-2:]
    dev = img.device
    if combined is None:
        combined = fast_score_dual(img, float(th_low), float(th_high), bonus=1e4)
    score = fast_nms(combined)
    zero = torch.zeros_like(score)
    score = torch.where(shi_tomasi_min_eig(img) > 20.0, score, zero)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    in_border = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    score = torch.where(in_border, score, zero)

    gh, gw = -(-h // cell), -(-w // cell)
    sp = torch.nn.functional.pad(score, (0, gw * cell - w, 0, gh * cell - h))
    cells = (
        sp.reshape(batch + (gh, cell, gw, cell)).transpose(-3, -2)
        .reshape(batch + (gh * gw, cell * cell))
    )
    best_in_cell = torch.argmax(cells, dim=-1)
    best_score = torch.gather(cells, -1, best_in_cell[..., None])[..., 0]
    g = torch.arange(gh * gw, device=dev)
    ys = (g // gw) * cell + best_in_cell // cell
    xs = (g % gw) * cell + best_in_cell % cell

    k = min(n_keep, gh * gw)
    top_score, order = torch.sort(best_score, dim=-1, descending=True, stable=True)
    top_score, top_idx = top_score[..., :k], order[..., :k]
    yx = torch.stack([torch.gather(ys, -1, top_idx), torch.gather(xs, -1, top_idx)], dim=-1)
    valid = top_score > 0
    if k < n_keep:
        yx = torch.nn.functional.pad(yx, (0, 0, 0, n_keep - k))
        top_score = torch.nn.functional.pad(top_score, (0, n_keep - k))
        valid = torch.nn.functional.pad(valid, (0, n_keep - k))
    # Report the raw response (strip the high-threshold bonus).
    resp = torch.where(top_score > 1e4, top_score - 1e4, top_score)
    return yx, torch.where(valid, resp, torch.zeros_like(resp)), valid
