"""FAST-9/16 corner detection as a dense, branch-free array program.

Port of `hfvo_tpu.ops.fast`. The whole image is scored at both thresholds
in one pass; high-threshold corners get a large bonus so the budgeted
selection prefers strong corners but falls back to weak ones in empty
regions (the intent of the reference's per-cell 20 -> 7 retry,
src/ORBextractor.cc:770-860).

`fast_score_dual` owns kernel K1 and its batched launch K1b, and
`fast_score` kernel K2 and its batched launch K2b: one source,
`csrc/fast_dual.cu` (the port of `hfvo_tpu/ops/pallas_fast.py::_kernel_dual`
and `::_kernel`), with the threshold count a template parameter. An (H, W)
image is K1 or K2, an (S, H, W) stack K1b or K2b: one launch for the stack.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

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

# Kernel launches, one per call on a CUDA tensor whatever S is: K1 and K2 on
# an (H, W) image, K1b and K2b on an (S, H, W) stack. Read and reset by
# callers that check a path used them.
fast_dual_launches = 0  # K1
fast_dual_batched_launches = 0  # K1b
fast_score_launches = 0  # K2
fast_score_batched_launches = 0  # K2b

# C interface of csrc/fast_dual.cu: (in, out, S, H, W, thresholds..., stream)
# -> cudaError_t.
_FAST_SIGNATURES = {
    "hfvo_fast_score_dual": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
    ),
    "hfvo_fast_score": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_float, ctypes.c_void_p],
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


def _launch(name: str, img: torch.Tensor, *scalars: float) -> torch.Tensor:
    """Run entry point `name` of csrc/fast_dual.cu on a contiguous float32
    (H, W) or (S, H, W) CUDA tensor; raises on a bad input or a failed
    launch."""
    if img.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() not in (2, 3) or not img.is_contiguous():
        raise ValueError(
            f"{name}: needs a contiguous (H, W) or (S, H, W) float32 tensor, got "
            f"{img.dtype} of shape {tuple(img.shape)}"
        )
    from . import _kernels

    lib = _kernels.load("fast_dual", _FAST_SIGNATURES)
    s, (h, w) = (img.shape[0] if img.dim() == 3 else 1), img.shape[-2:]
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = getattr(lib, f"hfvo_{name}")(
            ctypes.c_void_p(img.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            s, h, w, *(float(v) for v in scalars), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: {_kernels.error_string(lib, err)}")
    return out


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9/16 response map (kernel K2 on an (H, W) CUDA image, K2b
    on an (S, H, W) stack); see `fast_score_reference`. A CPU tensor goes
    to the plain version."""
    global fast_score_launches, fast_score_batched_launches
    if img.device.type == "cpu":
        return fast_score_reference(img, threshold)
    out = _launch("fast_score", img, threshold)
    if img.dim() == 3:
        fast_score_batched_launches += 1
    else:
        fast_score_launches += 1
    return out


def fast_score_dual(
    img: torch.Tensor, th_low: float, th_high: float, bonus: float = 1e4
) -> torch.Tensor:
    """Combined dual-threshold FAST priority map (kernel K1 on an (H, W)
    CUDA image, K1b on an (S, H, W) stack, one launch for the stack).

    img: float32, contiguous, in [0, 255]. A CPU tensor goes to
    `fast_score_dual_reference`; a CUDA tensor goes to the kernel."""
    global fast_dual_launches, fast_dual_batched_launches
    if img.device.type == "cpu":
        return fast_score_dual_reference(img, th_low, th_high, bonus)
    out = _launch("fast_score_dual", img, th_low, th_high, bonus)
    if img.dim() == 3:
        fast_dual_batched_launches += 1
    else:
        fast_dual_launches += 1
    return out


def pyramid_fast_scores(
    img: torch.Tensor, th_low: float, th_high: float, n_levels: int = 8, scale: float = 1.2
) -> List[torch.Tensor]:
    """The image pyramid of img (*B, H, W) and `fast_score` at both
    thresholds on every level, [low_0, high_0, low_1, ...]: the JAX
    package's "pyramid + 2x fast_score all levels" probe
    (profile_step.py:147-158), the path that runs kernel K2 (K2b on a
    stack)."""
    out = []
    for lvl in build_pyramid(img, n_levels, scale):
        lvl = lvl.contiguous()
        out += [fast_score(lvl, th_low), fast_score(lvl, th_high)]
    return out


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
    """
    batch = img.shape[:-2]
    h, w = img.shape[-2:]
    dev = img.device
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
