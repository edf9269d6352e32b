"""Dense optical flow and flow-based line recovery.

Port of the parts of `hfvo_tpu.ops.lk` that the tracking step runs
(reference: LSDmatcher::optical_flow_line, src/LSDmatcher.cpp:158-520:
sample points on an unmatched line, track them into the current frame,
refit the line): `warp_points_by_rotation`, `_avg_pool2`, `dense_flow_half`
and `recover_lines_by_flow`. The pyramidal LK (`pyr_lk`,
`recover_line_by_flow`) has no caller on the tracking path and comes later.

`dense_flow_half` computes its shifted-SAD cost volume in float32. The JAX
package casts it to bfloat16 on every backend (hfvo_tpu/ops/lk.py:164-173)
and bounds the effect at 0.3 px of flow (mean 0.02 px); the port follows
its float32 policy instead. Its box sums are cumulative-sum differences (the
JAX package's banded matmuls avoid a sequential cumsum on the TPU). Every
function also takes a leading sequence axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..geometry.camera import Intrinsics
from .image import bilinear_sample, pad2d


def warp_points_by_rotation(intr: Intrinsics, uv: torch.Tensor, R_10: torch.Tensor) -> torch.Tensor:
    """Initial guesses by the infinite-homography warp `K R K^-1`
    (reference seeds LK with the Manhattan rotation, src/LSDmatcher.cpp:260):
    uv (*B, N, 2), R_10 (*B, 3, 3)."""
    x = (uv[..., 0] - intr.cx) / intr.fx
    y = (uv[..., 1] - intr.cy) / intr.fy
    rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    r1 = rays @ R_10.transpose(-1, -2)
    z = torch.where(torch.abs(r1[..., 2]) > 1e-6, r1[..., 2], torch.full_like(r1[..., 2], 1e-6))
    return torch.stack(
        [intr.fx * r1[..., 0] / z + intr.cx, intr.fy * r1[..., 1] / z + intr.cy], dim=-1
    )


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[-2:]
    x = img[..., : h // 2 * 2, : w // 2 * 2]
    return x.reshape(img.shape[:-2] + (h // 2, 2, w // 2, 2)).mean(dim=(-3, -1))


def _box_sum(C: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Sum over the window [i - r, i + r] along `dim`, zero outside: the JAX
    package's banded |i - j| <= r contraction, by cumulative sums."""
    dim = dim % C.dim()
    n = C.shape[dim]
    # r + 1 leading zeros and r trailing: window [i - r, i + r] of C is
    # (i, i + 2r + 1] of the padded cumulative sum.
    pad = [0, 0] * (C.dim() - 1 - dim) + [r + 1, r]
    cs = torch.cumsum(F.pad(C, pad), dim=dim)
    return cs.narrow(dim, 2 * r + 1, n) - cs.narrow(dim, 0, n)


def dense_flow_half(
    img0: torch.Tensor,  # (*B, H, W) float32 source frame
    img1: torch.Tensor,  # (*B, H, W) target frame
    search: int = 12,  # half-res px -> covers +-2*search full-res px
    box: int = 11,  # SAD aggregation window (half-res px)
):
    """Dense optical flow at half resolution via a shifted-SAD cost volume
    with softmin sub-pixel interpolation. Returns (flow (*B, H//2, W//2, 2)
    in full-resolution pixels, img0 -> img1; conf (*B, H//2, W//2), the
    best aggregated SAD per pixel divided by box^2).

    The volume streams over the vertical shift dy: each dy-row of
    (2 * search + 1) horizontal shifts is box-filtered and folded into a
    running softmin with the running-minimum correction."""
    a = _avg_pool2(img0)
    b = _avg_pool2(img1)
    h, w = a.shape[-2:]
    pad = pad2d(b, (search, search, search, search), "replicate")
    k = box
    tau = 2.0 * float(k * k)
    r2 = k // 2
    dev = a.device
    dxs = torch.arange(-search, search + 1, device=dev).float()
    M = torch.full(a.shape, 1e30, device=dev)
    S0 = torch.zeros(a.shape, device=dev)
    Sx = torch.zeros(a.shape, device=dev)
    Sy = torch.zeros(a.shape, device=dev)
    for dy in range(-search, search + 1):
        band = pad[..., search + dy : search + dy + h, :]  # (*B, h, w + 2 * search)
        # Window k of a band row is the shift dx = k - search: (*B, 2s + 1, h, w).
        C = torch.abs(a[..., None, :, :] - band.unfold(-1, w, 1).transpose(-3, -2))
        C = _box_sum(_box_sum(C, r2, -2), r2, -1)
        M_new = torch.minimum(M, torch.amin(C, dim=-3))
        scale = torch.exp((M_new - M) / tau)  # <= 1, rescales old sums
        Wt = torch.exp(-(C - M_new[..., None, :, :]) / tau)
        sw = torch.sum(Wt, dim=-3)
        S0 = S0 * scale + sw
        Sx = Sx * scale + torch.einsum("...dhw,d->...hw", Wt, dxs)
        Sy = Sy * scale + sw * float(dy)
        M = M_new
    fx = Sx / (S0 + 1e-12)
    fy = Sy / (S0 + 1e-12)
    flow = torch.stack([fx, fy], dim=-1) * 2.0  # half-res disp -> full px
    conf = M / float(k * k)
    return flow, conf


def recover_lines_by_flow(
    intr: Intrinsics,
    img0: torch.Tensor,  # (*B, H, W) previous frame
    img1: torch.Tensor,  # (*B, H, W) current frame
    p0_seg: torch.Tensor,  # (*B, NL, 2) segment endpoints in img0
    p1_seg: torch.Tensor,  # (*B, NL, 2)
    seg_valid: torch.Tensor,  # (*B, NL) bool - which segments to track
    R_10: torch.Tensor,  # (*B, 3, 3) rotation prior (cam1 <- cam0); unused, as in the JAX package
    n_pts: int = 16,
):
    """Batched line recovery by dense flow (reference: per-line
    cv::calcOpticalFlowPyrLK in LSDmatcher::optical_flow_line): sample
    `n_pts` points along each segment, displace them by the half-res flow,
    and refit a 2D line by weighted PCA. Returns (q0 (*B, NL, 2),
    q1 (*B, NL, 2), ok (*B, NL))."""
    NL = p0_seg.shape[-2]
    dev = p0_seg.device
    ts = (torch.arange(n_pts, device=dev).float() + 0.5) / n_pts
    pts = p0_seg[..., None, :] + (p1_seg - p0_seg)[..., None, :] * ts[:, None]
    flat = pts.reshape(pts.shape[:-3] + (-1, 2))
    flow, conf = dense_flow_half(img0, img1)
    half_xy = flat / 2.0
    fx = bilinear_sample(flow[..., 0].contiguous(), half_xy)
    fy = bilinear_sample(flow[..., 1].contiguous(), half_xy)
    cf = bilinear_sample(conf, half_xy)
    tracked = flat + torch.stack([fx, fy], dim=-1)
    h, w = img0.shape[-2:]
    inb = (
        (tracked[..., 0] >= 2.0) & (tracked[..., 0] < w - 2.0)
        & (tracked[..., 1] >= 2.0) & (tracked[..., 1] < h - 2.0)
    )
    # Photometric agreement at the matched location (single sample).
    i0 = bilinear_sample(img0, flat)
    i1 = bilinear_sample(img1, tracked)
    ok_pt = inb & (torch.abs(i0 - i1) < 24.0) & (cf < 20.0)
    tracked = tracked.reshape(pts.shape)
    ok_pt = ok_pt.reshape(pts.shape[:-1]) & seg_valid[..., None]
    wgt = ok_pt.float()
    sw = torch.sum(wgt, dim=-1) + 1e-9
    c = torch.sum(tracked * wgt[..., None], dim=-2) / sw[..., None]
    d = tracked - c[..., None, :]
    cxx = torch.sum(wgt * d[..., 0] * d[..., 0], dim=-1) / sw
    cyy = torch.sum(wgt * d[..., 1] * d[..., 1], dim=-1) / sw
    cxy = torch.sum(wgt * d[..., 0] * d[..., 1], dim=-1) / sw
    phi = 0.5 * torch.atan2(2 * cxy, cxx - cyy)
    u = torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    along = torch.sum(d * u[..., None, :], dim=-1)
    big = torch.tensor(1e9, device=dev)
    a_min = torch.min(torch.where(ok_pt, along, big), dim=-1).values
    a_max = torch.max(torch.where(ok_pt, along, -big), dim=-1).values
    nrm = torch.stack([-u[..., 1], u[..., 0]], -1)
    perp = torch.abs(torch.sum(d * nrm[..., None, :], dim=-1))
    # Fit gate mirrors the reference's point-line distance tiers
    # (src/LSDmatcher.cpp:420-470).
    good_fit = torch.sum((perp < 2.5) & ok_pt, dim=-1) >= max(n_pts // 2, 5)
    ok = seg_valid & good_fit & (a_max > a_min)
    q0 = c + u * a_min[..., None]
    q1 = c + u * a_max[..., None]
    return q0, q1, ok
