"""The ORB scale pyramid: level l is level l - 1 resized to
(round(H / s^l), round(W / s^l)) by the antialiased bilinear resampling of
`jax.image.resize` (a triangle kernel widened by the scale factor when
shrinking, weights normalized per output sample, rows first), in float64."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import rounder


def weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float64 resampling matrix along one axis."""
    inv_scale = in_size / out_size
    kscale = max(inv_scale, 1.0)
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size)[:, None]) / kscale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(total != 0, w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, 0.0).T)


def shapes(h: int, w: int, n_levels: int, scale: float):
    return [(int(round(h / scale ** l)), int(round(w / scale ** l))) for l in range(n_levels)]


def pyramid(gray_u8: torch.Tensor, n_levels: int, scale: float, tf32: bool = False) -> List[torch.Tensor]:
    """Levels (*B, h_l, w_l) of a uint8 image or stack, float64 (float32
    rounded to TF32 with `tf32`)."""
    rnd = rounder(tf32)
    dt = torch.float32 if tf32 else torch.float64
    x = gray_u8.to(dt)
    h, w = x.shape[-2:]
    out = [x]
    for hh, ww in shapes(h, w, n_levels, scale)[1:]:
        prev = out[-1]
        wh = rnd(torch.from_numpy(weights(prev.shape[-2], hh)).to(prev.device, dt))
        ww_ = rnd(torch.from_numpy(weights(prev.shape[-1], ww)).to(prev.device, dt))
        out.append(rnd(rnd(wh @ prev) @ ww_.T))
    return out
