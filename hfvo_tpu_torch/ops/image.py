"""Basic image ops: separable Gaussian blur, resize, gradients, pyramids,
bilinear sampling.

Port of `hfvo_tpu.ops.image` on (H, W) float32 torch tensors; every
function also takes leading batch dims, (S, H, W) for S sequences.

Resizing reproduces `jax.image.resize` (which `hfvo_tpu` calls for every
pyramid level) rather than `F.interpolate`: the output is a separable
contraction with one weight matrix per axis, built exactly as
`jax._src.image.scale.compute_weight_mat` builds it — kernel evaluated at
half-pixel-centred sample offsets, widened by the downscale factor
(antialiasing), normalised per output sample. Built in float32 numpy, the
weights are bit-identical to JAX's, so pyramid levels agree to matmul
rounding (~1e-5 of 255) instead of the ~4e-3 of `F.interpolate(...,
antialias=True)`.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .batch import gather_pixels


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def pad2d(img: torch.Tensor, pad, mode: str) -> torch.Tensor:
    """F.pad of the last two dims of (*B, H, W) in a reflect or replicate
    mode (which take (N, C, H, W))."""
    h, w = img.shape[-2:]
    x = F.pad(img.reshape(-1, 1, h, w), pad, mode=mode)
    return x.reshape(img.shape[:-2] + x.shape[-2:])


def _conv1d(img: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    """Separable 1D convolution along `axis` (0 = rows, 1 = columns of the
    last two dims) with reflect padding, as a shift-and-accumulate in tap
    order (the JAX package's sum order)."""
    r = (k.shape[0] - 1) // 2
    pad = (0, 0, r, r) if axis == 0 else (r, r, 0, 0)
    x = pad2d(img, pad, "reflect")
    n = img.shape[axis - 2]
    out = torch.zeros_like(img)
    for i in range(k.shape[0]):
        sl = x[..., i : i + n, :] if axis == 0 else x[..., i : i + n]
        out = out + float(k[i]) * sl
    return out


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """7x7 Gaussian blur (sigma 2) by default, the pre-descriptor blur of the
    reference (src/ORBextractor.cc:1036 `GaussianBlur(..., Size(7,7), 2, 2)`)."""
    k = gaussian_kernel1d(sigma, radius)
    return _conv1d(_conv1d(img, k, 0), k, 1)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(
        x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x
        + np.float32(2.0), out,
    )
    return np.where(x >= 2.0, np.float32(0), out).astype(np.float32)


_KERNELS = {"bilinear": _triangle, "cubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(out_size, in_size) float32 resampling matrix of `jax.image.resize`
    along one axis (antialiased, zero translation)."""
    kernel = _KERNELS[method]
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = (
        (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
        - np.float32(0.0) - np.float32(0.5)
    )
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = kernel(x.astype(np.float32)).astype(np.float32)
    total = np.sum(w, axis=0, keepdims=True, dtype=np.float32)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, np.float32(1)),
        np.float32(0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, np.float32(0)).astype(np.float32)
    return np.ascontiguousarray(w.T)


@functools.lru_cache(maxsize=None)
def _weights_on(in_size: int, out_size: int, method: str, device: str) -> torch.Tensor:
    return torch.from_numpy(resize_weights(in_size, out_size, method)).to(device)


def resize(img: torch.Tensor, out_hw: Tuple[int, int], method: str) -> torch.Tensor:
    """`jax.image.resize(img, out_hw, method)` for (*B, H, W) float32: rows
    are resampled first, then columns; an axis whose size is unchanged is
    left as it is, as in JAX."""
    h, w = img.shape[-2:]
    out = img
    dev = str(img.device)
    if out_hw[0] != h:
        out = _weights_on(h, out_hw[0], method, dev) @ out
    if out_hw[1] != w:
        out = out @ _weights_on(w, out_hw[1], method, dev).T
    return out


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    return resize(img, out_hw, "bilinear")


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float) -> List[Tuple[int, int]]:
    return [
        (int(round(h / scale**l)), int(round(w / scale**l))) for l in range(n_levels)
    ]


def build_pyramid(
    img: torch.Tensor, n_levels: int = 8, scale: float = 1.2
) -> List[torch.Tensor]:
    """Image pyramid (reference: src/ORBextractor.cc:1105 `ComputePyramid`).
    Each level is resized from the previous one, as in the JAX package."""
    h, w = img.shape[-2:]
    out = [img]
    for hw in pyramid_shapes(h, w, n_levels, scale)[1:]:
        out.append(resize_bilinear(out[-1], hw))
    return out


def sobel_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy) Sobel gradients with reflect padding."""
    x = pad2d(img, (1, 1, 1, 1), "reflect")
    gx = (
        (x[..., :-2, 2:] + 2 * x[..., 1:-1, 2:] + x[..., 2:, 2:])
        - (x[..., :-2, :-2] + 2 * x[..., 1:-1, :-2] + x[..., 2:, :-2])
    ) * 0.25
    gy = (
        (x[..., 2:, :-2] + 2 * x[..., 2:, 1:-1] + x[..., 2:, 2:])
        - (x[..., :-2, :-2] + 2 * x[..., :-2, 1:-1] + x[..., :-2, 2:])
    ) * 0.25
    return gx, gy


def maxpool2d_same(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    """k x k max pool with stride 1 and same shape (for NMS); the padding
    reads as -inf."""
    h, w = x.shape[-2:]
    return F.max_pool2d(x.reshape(-1, 1, h, w), k, stride=1, padding=k // 2).reshape(x.shape)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img (*B, H, W) at float coords (*B, *K, 2) as
    (x, y); out-of-bounds coords are clamped to [0, w - 1.001] x
    [0, h - 1.001], the JAX package's constant, so the +1 neighbour always
    lies inside the image."""
    h, w = img.shape[-2:]
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    v00 = gather_pixels(img, y0, x0)
    v01 = gather_pixels(img, y0, x0 + 1)
    v10 = gather_pixels(img, y0 + 1, x0)
    v11 = gather_pixels(img, y0 + 1, x0 + 1)
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def extract_patches(
    img: torch.Tensor, centers_yx: torch.Tensor, radius: int
) -> torch.Tensor:
    """Gather square patches (*B, N, 2r+1, 2r+1) of img (*B, H, W) around
    integer centers (*B, N, 2).

    Centers are clamped so patches stay in bounds, as in the JAX package.
    (Its one-hot matmul form is a TPU lowering workaround; a gather gives the
    same values.)"""
    size = 2 * radius + 1
    h, w = img.shape[-2:]
    y0 = torch.clamp(centers_yx[..., 0] - radius, 0, h - size).long()
    x0 = torch.clamp(centers_yx[..., 1] - radius, 0, w - size).long()
    span = torch.arange(size, device=img.device)
    ys = (y0[..., None] + span)[..., :, None]
    xs = (x0[..., None] + span)[..., None, :]
    return gather_pixels(img, ys.expand(ys.shape[:-1] + (size,)), xs.expand(xs.shape[:-2] + (size, size)))
