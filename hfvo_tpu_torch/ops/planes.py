"""Plane segmentation and surface normals from organized depth.

Port of `hfvo_tpu.ops.planes` (reference: PEAC's agglomerative plane fitter,
include/peac/AHCPlaneFitter.hpp, wrapped by src/PlaneExtractor.cpp):

1. block-wise plane fits (16x16 px): two-pass centroid and covariance per
   block, and the smallest eigenvector of each by the Jacobi `eigh3`;
2. 12 label-propagation sweeps: each block adopts the least label among its
   4-neighbours whose normals agree and whose planes are mutually
   consistent, then follows its label's label twice (pointer jumping);
3. a per-label refit from the blocks' moments (parallel-axis theorem), and
   the `max_planes` labels of most support.

The JAX package pools blocks with one-hot matmuls and jumps pointers with a
compare-reduce over the label table, both TPU lowering workarounds; here a
block is a reshape-sum and a jump is a gather (exactly one table entry
matches each block, so it is the same function). Every function takes a
leading sequence axis: depth (*B, H, W).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry.camera import Intrinsics
from . import sym_eig

BLOCK = 16
N_PROP_ITERS = 12
_NEIGH = ((0, 1), (0, -1), (1, 0), (-1, 0))


class PlaneSegmentation(NamedTuple):
    planes: torch.Tensor  # (*B, P, 4): unit normal (towards camera) + d; n.X + d = 0
    centroids: torch.Tensor  # (*B, P, 3)
    counts: torch.Tensor  # (*B, P) supporting-block pixel counts
    valid: torch.Tensor  # (*B, P)
    block_label: torch.Tensor  # (*B, nby, nbx) int64 plane row per block (-1 none)
    block_centroid: torch.Tensor  # (*B, nby, nbx, 3) per-block centroids
    covs: torch.Tensor  # (*B, P, 3, 3) point scatter about the centroid


def depth_to_cloud(depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """(*B, H, W) metres -> (*B, H, W, 3) camera-frame points."""
    h, w = depth.shape[-2:]
    yy = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    X = (xx - intr.cx) / intr.fx * depth
    Y = (yy - intr.cy) / intr.fy * depth
    return torch.stack([X, Y, depth], dim=-1)


def _depth_sigma(z: torch.Tensor) -> torch.Tensor:
    """PEAC's depth-dependent noise, sigma_z ~ 0.0012 + 0.0019 (z - 0.4)^2."""
    return 0.0012 + 0.0019 * (z - 0.4) ** 2


def _plane_from_cov(mu: torch.Tensor, cov: torch.Tensor):
    """(normal towards the camera, d, smallest eigenvalue) of the plane
    through `mu` with scatter `cov`."""
    evals, evecs = sym_eig.eigh3(cov + 1e-10 * torch.eye(3, device=cov.device))
    normal = evecs[..., 0]
    # Orient towards the camera (n . viewdir < 0 with viewdir = mu).
    sign = torch.where(torch.sum(normal * mu, dim=-1, keepdim=True) > 0, -1.0, 1.0)
    normal = normal * sign
    return normal, -torch.sum(normal * mu, dim=-1), evals[..., 0]


def _shift(a: torch.Tensor, dy: int, dx: int, fill, channels: int = 0) -> torch.Tensor:
    """out[..., y, x, *C] = a[..., y + dy, x + dx, *C], `fill` outside the
    grid; the (nby, nbx) grid is followed by `channels` trailing dims."""
    yd, xd = -2 - channels, -1 - channels
    nby, nbx = a.shape[yd], a.shape[xd]
    out = torch.full_like(a, fill)
    src = a.narrow(yd, max(dy, 0), nby - abs(dy)).narrow(xd, max(dx, 0), nbx - abs(dx))
    out.narrow(yd, max(-dy, 0), nby - abs(dy)).narrow(xd, max(-dx, 0), nbx - abs(dx)).copy_(src)
    return out


def _compatible(na, da, mua, nb, db, mub):
    """Neighbouring block planes agree: normals within ~18 deg and each
    centroid near the other's plane (mutual point-plane distance)."""
    ang = torch.sum(na * nb, dim=-1) > 0.95
    d_ab = torch.abs(torch.sum(nb * mua, dim=-1) + db)
    d_ba = torch.abs(torch.sum(na * mub, dim=-1) + da)
    lim = 6 * _depth_sigma(mua[..., 2]) + 0.01
    return ang & (d_ab < lim) & (d_ba < lim)


def segment_planes(
    depth: torch.Tensor,
    intr: Intrinsics,
    max_planes: int = 32,
    mse_factor: float = 3.0,
    min_blocks: int = 6,
) -> PlaneSegmentation:
    """depth (*B, H, W) metres -> PlaneSegmentation with (*B, max_planes)
    rows, in order of support (ties: the lower label first)."""
    batch = depth.shape[:-2]
    dev = depth.device
    h, w = depth.shape[-2:]
    nby, nbx = h // BLOCK, w // BLOCK
    Hc, Wc = nby * BLOCK, nbx * BLOCK
    cloud = depth_to_cloud(depth, intr)[..., :Hc, :Wc, :]
    Vf = (depth[..., :Hc, :Wc] > 1e-3).float()

    def pool(m):  # (*B, Hc, Wc, *C) -> (*B, nby, nbx, *C)
        c = m.shape[len(batch) + 2:]
        return m.reshape(batch + (nby, BLOCK, nbx, BLOCK) + c).sum(dim=(len(batch) + 1, len(batch) + 3))

    def bcast(b):  # (*B, nby, nbx, *C) -> (*B, Hc, Wc, *C), nearest block
        return b.repeat_interleave(BLOCK, dim=len(batch)).repeat_interleave(BLOCK, dim=len(batch) + 1)

    # Two-pass block moments: covariance about each block's OWN mean (the
    # one-pass E[XX^T] - mu mu^T form cancels in float32 for far or grazing
    # geometry and tilts normals by tenths of a degree).
    n_valid = pool(Vf)
    n_safe = torch.clamp(n_valid, min=1.0)
    mu_b = pool(cloud * Vf[..., None]) / n_safe[..., None]  # (*B, nby, nbx, 3)
    cen = cloud - bcast(mu_b)
    cov_b = pool(cen[..., :, None] * cen[..., None, :] * Vf[..., None, None]) / n_safe[..., None, None]

    normal, d, mse = _plane_from_cov(mu_b, cov_b)
    # Block validity: enough depth and planar enough (depth-scaled MSE).
    block_ok = (n_valid > 0.8 * BLOCK * BLOCK) & (mse < (mse_factor * _depth_sigma(mu_b[..., 2])) ** 2)

    # Label propagation over flat block ids; invalid blocks hold the sentinel.
    n_blk = nby * nbx
    sentinel = n_blk
    flat_ids = torch.arange(n_blk, device=dev).reshape(nby, nbx)
    label = torch.where(block_ok, flat_ids, sentinel)
    comp_masks = []
    for dy, dx in _NEIGH:
        nok = _shift(block_ok, dy, dx, False)
        comp_masks.append(block_ok & nok & _compatible(
            normal, d, mu_b,
            _shift(normal, dy, dx, 0.0, 1), _shift(d, dy, dx, 1e9), _shift(mu_b, dy, dx, 0.0, 1),
        ))
    tail = torch.full(batch + (1,), sentinel, dtype=torch.int64, device=dev)
    for _ in range(N_PROP_ITERS):
        best = label
        for (dy, dx), cm in zip(_NEIGH, comp_masks):
            best = torch.where(cm, torch.minimum(best, _shift(label, dy, dx, sentinel)), best)
        # Pointer jumping: adopt the label of the block my label points to
        # (the sentinel maps to itself).
        for _ in range(2):
            flat = torch.cat([best.reshape(batch + (n_blk,)), tail], dim=-1)
            picked = flat.gather(-1, best.reshape(batch + (n_blk,))).reshape(best.shape)
            best = torch.minimum(best, picked)
        label = best

    # Per-label refit: merge block moments by the parallel-axis theorem.
    nlbl = n_blk + 1
    n_seq = math.prod(batch)
    flat_label = (label.reshape(n_seq, n_blk)
                  + torch.arange(n_seq, device=dev)[:, None] * nlbl).reshape(-1)
    w_blk = torch.where(block_ok, n_valid, 0.0).reshape(-1)
    mu_f = mu_b.reshape(-1, 3)

    def scatter(v):  # per-block values (n_seq * n_blk, *C) -> (*B, nlbl, *C)
        out = torch.zeros((n_seq * nlbl,) + v.shape[1:], device=dev)
        return out.index_add_(0, flat_label, v).reshape(batch + (nlbl,) + v.shape[1:])

    cnt = scatter(w_blk)
    cnt_safe = torch.clamp(cnt, min=1.0)
    Mup = scatter(w_blk[:, None] * mu_f) / cnt_safe[..., None]
    dmu = mu_f - Mup.reshape(-1, 3)[flat_label]
    S2c = scatter(w_blk[:, None, None] * (cov_b.reshape(-1, 3, 3) + dmu[:, :, None] * dmu[:, None, :]))
    Cov_l = S2c / cnt_safe[..., None, None]
    nblocks = scatter(block_ok.reshape(-1).float())
    ok = (nblocks >= min_blocks) & (torch.arange(nlbl, device=dev) < n_blk)

    # The labels of most support. A stable descending sort puts the lower
    # label first among equal counts, as jax.lax.top_k does.
    score = torch.where(ok, cnt, -1.0)
    k = min(max_planes, nlbl)
    top_cnt, top_lbl = torch.sort(score, dim=-1, descending=True, stable=True)
    top_cnt, top_lbl = top_cnt[..., :k], top_lbl[..., :k]
    # The eigensolve runs on the chosen labels only (each row is solved on
    # its own, so this is the same result as solving every label).
    Mu_k = Mup.gather(-2, top_lbl[..., None].expand(top_lbl.shape + (3,)))
    Cov_k = Cov_l.gather(-3, top_lbl[..., None, None].expand(top_lbl.shape + (3, 3)))
    Np, Dp, _ = _plane_from_cov(Mu_k, Cov_k)
    planes = torch.cat([Np, Dp[..., None]], dim=-1)
    pvalid = top_cnt > 0
    if k < max_planes:
        pad = max_planes - k
        planes = torch.nn.functional.pad(planes, (0, 0, 0, pad))
        Mu_k = torch.nn.functional.pad(Mu_k, (0, 0, 0, pad))
        Cov_k = torch.nn.functional.pad(Cov_k, (0, 0, 0, 0, 0, pad))
        top_cnt = torch.nn.functional.pad(top_cnt, (0, pad))
        pvalid = torch.nn.functional.pad(pvalid, (0, pad))

    # Block -> plane row map.
    row_of_label = torch.full(batch + (nlbl,), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(k, device=dev).expand(top_lbl.shape)
    row_of_label.scatter_(-1, top_lbl, torch.where(pvalid[..., :k], rows, -1))
    block_row = row_of_label.gather(-1, label.reshape(batch + (n_blk,))).reshape(label.shape)
    return PlaneSegmentation(
        planes, Mu_k, torch.clamp(top_cnt, min=0.0), pvalid, block_row, mu_b, Cov_k
    )


def compute_normals(depth: torch.Tensor, intr: Intrinsics, stride: int = 4):
    """Surface normals from central differences of the cloud, subsampled
    by `stride` (reference: PCL integral-image normals,
    src/Frame.cc:2157-2210). depth (*B, H, W) -> (normals (*B, Ns, 3)
    camera-frame unit vectors towards the camera, valid (*B, Ns)). The
    validity of a sample needs its 4 neighbours' depth, with wrap-around
    at the borders as in the JAX package (`jnp.roll`)."""
    c = depth_to_cloud(depth, intr)[..., ::stride, ::stride, :]
    v = (depth > 1e-3)[..., ::stride, ::stride]
    du = torch.zeros_like(c)
    du[..., :, 1:-1, :] = (c[..., :, 2:, :] - c[..., :, :-2, :]) * 0.5
    dv = torch.zeros_like(c)
    dv[..., 1:-1, :, :] = (c[..., 2:, :, :] - c[..., :-2, :, :]) * 0.5
    n = torch.linalg.cross(du, dv, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.where(norm > 1e-9, norm, 1.0)
    n = n * torch.where(torch.sum(n * c, dim=-1, keepdim=True) > 0, -1.0, 1.0)
    ok = (
        v & (norm[..., 0] > 1e-9)
        & torch.roll(v, 1, -2) & torch.roll(v, -1, -2)
        & torch.roll(v, 1, -1) & torch.roll(v, -1, -1)
    )
    batch = depth.shape[:-2]
    return n.reshape(batch + (-1, 3)), ok.reshape(batch + (-1,))
