"""FAST-9/16 corner scores (Rosten and Drummond, ECCV 2006), as ORB-SLAM2
scores them at two thresholds: a pixel is a corner at threshold t where 9
contiguous pixels of its radius-3 Bresenham ring are all brighter than
c + t or all darker than c - t; its score is the larger of the bright sum
of (r - c) - t and the dark sum of (c - t) - r over the ring, added in ring
order from 12 o'clock clockwise; pixels within 3 of the border score 0.
The dual map is s_high + bonus where the high threshold finds a corner,
else s_low."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import rounder

RING = [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)]
ARC = 9


def _arc(flags):
    """True where 9 ring flags in a row (circularly) are all set."""
    n = len(flags)
    out = torch.zeros_like(flags[0])
    for s in range(n):
        run = flags[s]
        for j in range(1, ARC):
            run = run & flags[(s + j) % n]
        out = out | run
    return out


def score(img: torch.Tensor, th: float, tf32: bool = False) -> torch.Tensor:
    rnd = rounder(tf32)
    img = rnd(img.to(torch.float32))
    h, w = img.shape[-2:]
    pad = F.pad(img, (3, 3, 3, 3))
    hi, lo = rnd(img + th), rnd(img - th)
    zero = torch.zeros_like(img)
    bright_s, dark_s, bright, dark = zero, zero, [], []
    for dy, dx in RING:
        r = pad[..., 3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w]
        b, d = r > hi, r < lo
        bright.append(b)
        dark.append(d)
        bright_s = rnd(bright_s + torch.where(b, rnd(rnd(r - img) - th), zero))
        dark_s = rnd(dark_s + torch.where(d, rnd(lo - r), zero))
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inner = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    corner = (_arc(bright) | _arc(dark)) & inner
    return torch.where(corner, torch.maximum(bright_s, dark_s), zero)


def dual_score(img: torch.Tensor, th_low: float, th_high: float, bonus: float,
               tf32: bool = False) -> torch.Tensor:
    s_low, s_high = score(img, th_low, tf32), score(img, th_high, tf32)
    return torch.where(s_high > 0, rounder(tf32)(s_high + bonus), s_low)
