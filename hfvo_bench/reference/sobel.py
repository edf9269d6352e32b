"""3x3 Sobel gradients with reflected borders, scaled by 1/4, their
magnitude, and the line-normal angle atan2(gy, gx) mod pi, in float64."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import rounder


def gradients(gray_u8: torch.Tensor, tf32: bool = False):
    """(mag, angle) of a uint8 image or stack (*B, H, W)."""
    rnd = rounder(tf32)
    dt = torch.float32 if tf32 else torch.float64
    img = gray_u8.to(dt)
    h, w = img.shape[-2:]
    x = F.pad(img.reshape(-1, 1, h, w), (1, 1, 1, 1), mode="reflect").reshape(img.shape[:-2] + (h + 2, w + 2))
    gx = rnd(((x[..., :-2, 2:] + 2 * x[..., 1:-1, 2:] + x[..., 2:, 2:])
              - (x[..., :-2, :-2] + 2 * x[..., 1:-1, :-2] + x[..., 2:, :-2])) * 0.25)
    gy = rnd(((x[..., 2:, :-2] + 2 * x[..., 2:, 1:-1] + x[..., 2:, 2:])
              - (x[..., :-2, :-2] + 2 * x[..., :-2, 1:-1] + x[..., :-2, 2:])) * 0.25)
    mag = rnd(torch.sqrt(gx * gx + gy * gy))
    ang = rnd(torch.remainder(torch.atan2(gy, gx), math.pi))
    return mag, ang
