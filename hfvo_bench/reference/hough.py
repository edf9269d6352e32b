"""The tiled Hough vote of the program's line detector, as published in its
docstring: each 64x64 tile of the image has a 36 x 48 (theta, rho)
accumulator; each pixel with magnitude above the threshold adds its
magnitude at its own line-normal bin (angle / pi * 36, truncated) and half
of it at the two neighbouring theta rows (mod 36), at rho = x cos + y sin of
the target row's centre angle (x, y inside the tile), binned as
(rho / (64 sqrt 2) + 1) * 24, truncated and clamped. The bins are computed
in float32, as the definition states them; the sums in float64."""
from __future__ import annotations

import math

import numpy as np
import torch

from . import rounder

TILE, N_THETA, N_RHO = 64, 36, 48
DIAG = TILE * math.sqrt(2.0)


def _tiles(a: torch.Tensor) -> torch.Tensor:
    h, w = a.shape[-2:]
    ty, tx = h // TILE, w // TILE
    b = a.shape[:-2]
    return (a[..., : ty * TILE, : tx * TILE].reshape(b + (ty, TILE, tx, TILE))
            .transpose(-3, -2).reshape(-1, TILE * TILE))


def vote(mag: torch.Tensor, ang: torch.Tensor, mag_th: float, tf32: bool = False) -> torch.Tensor:
    """(n_tiles, 36, 48) accumulators of float32 (mag, angle) images or
    stacks; float64 sums (float32 rounded to TF32 with `tf32`)."""
    rnd = rounder(tf32)
    dev = mag.device
    m = _tiles(rnd(mag.to(torch.float32)))
    a = _tiles(ang.to(torch.float32))
    th = (np.arange(N_THETA, dtype=np.float32) + np.float32(0.5)) / np.float32(N_THETA)
    th = (th * np.float32(np.pi)).astype(np.float64)
    cos = torch.from_numpy(np.cos(th).astype(np.float32)).to(dev)
    sin = torch.from_numpy(np.sin(th).astype(np.float32)).to(dev)
    p = torch.arange(TILE * TILE, device=dev)
    xl, yl = (p % TILE).float(), (p // TILE).float()
    tb = torch.clamp((a / math.pi * N_THETA).to(torch.int32), 0, N_THETA - 1).long()
    dt = torch.float32 if tf32 else torch.float64
    wgt = torch.where(m > mag_th, m, torch.zeros_like(m)).to(dt)
    T = m.shape[0]
    base = torch.arange(T, device=dev)[:, None] * (N_THETA * N_RHO)
    acc = torch.zeros(T * N_THETA * N_RHO, dtype=dt, device=dev)
    for delta, scale in ((0, 1.0), (-1, 0.5), (1, 0.5)):
        t = torch.remainder(tb + delta, N_THETA)
        rho = xl * cos[t] + yl * sin[t]
        rb = torch.clamp(((rho / DIAG + 1.0) * 0.5 * N_RHO).to(torch.int32), 0, N_RHO - 1).long()
        acc.index_add_(0, (base + t * N_RHO + rb).reshape(-1), (wgt * scale).reshape(-1))
    return rnd(acc).reshape(T, N_THETA, N_RHO)
