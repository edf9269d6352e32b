"""Pyramidal Lucas-Kanade, dense optical flow and flow-based line recovery.

Port of `hfvo_tpu.ops.lk` (reference: LSDmatcher::optical_flow_line,
src/LSDmatcher.cpp:158-520: sample points on an unmatched line, track them
into the current frame, refit the line). The tracking step runs
`warp_points_by_rotation`, `dense_flow_half` and `recover_lines_by_flow`;
`pyr_lk` and `recover_line_by_flow` (the rotation-seeded pyramidal LK of
one segment) have no caller on a path of either package.

`pyr_lk` tracks every point at once: its (2 * WIN + 1)^2 window is one
(N, W2) gather per image and iteration, and each point's 2x2 system is
inverted elementwise by LU with partial pivoting, the algorithm behind
`jnp.linalg.inv`, rather than by the adjugate.

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
from .image import bilinear_sample, build_pyramid, pad2d, sobel_gradients

WIN = 7  # window half-size -> (2 * WIN + 1)^2 patch


def _offsets(r: int, device) -> torch.Tensor:
    """(x, y) offsets of the (2r + 1)^2 window, x fastest, as the JAX
    package's `meshgrid(..., indexing="xy")`: (W2, 2)."""
    a = torch.arange(-r, r + 1, device=device).float()
    return torch.stack(torch.meshgrid(a, a, indexing="xy"), dim=-1).reshape(-1, 2)


def _inv2x2(a, b, c, d):
    """Inverse of [[a, b], [c, d]] (elementwise over any shape) as LU with
    partial pivoting, multiplying by the pivots' reciprocals: rows of
    ((i00, i01), (i10, i11))."""
    swap = torch.abs(c) > torch.abs(a)
    p, q = torch.where(swap, c, a), torch.where(swap, d, b)
    r, s = torch.where(swap, a, c), torch.where(swap, b, d)
    rp = 1.0 / p
    l = r * rp
    ru = 1.0 / (s - l * q)
    one, zero = torch.ones_like(a), torch.zeros_like(a)

    def column(e1, e2):  # solve for the right-hand side (e1, e2) after the row swap
        x2 = (e2 - l * e1) * ru
        return (e1 - q * x2) * rp, x2

    i00, i10 = column(torch.where(swap, zero, one), torch.where(swap, one, zero))
    i01, i11 = column(torch.where(swap, one, zero), torch.where(swap, zero, one))
    return (i00, i01), (i10, i11)


def _lk_level(
    img0: torch.Tensor,  # (*B, H, W) source level
    img1: torch.Tensor,  # (*B, H, W) target level
    gx0: torch.Tensor,
    gy0: torch.Tensor,
    p0: torch.Tensor,  # (*B, N, 2) source points at this level
    p1: torch.Tensor,  # (*B, N, 2) current estimates at this level
    n_iters: int,
) -> torch.Tensor:
    offs = _offsets(WIN, p0.device)
    pts0 = p0[..., None, :] + offs  # (*B, N, W2, 2)
    I0 = bilinear_sample(img0, pts0)
    Ix = bilinear_sample(gx0, pts0)
    Iy = bilinear_sample(gy0, pts0)
    sxx = torch.sum(Ix * Ix, dim=-1) + 1e-4
    sxy = torch.sum(Ix * Iy, dim=-1)
    syy = torch.sum(Iy * Iy, dim=-1) + 1e-4
    (i00, i01), (i10, i11) = _inv2x2(sxx, sxy, sxy, syy)
    q = p1
    for _ in range(n_iters):
        dI = bilinear_sample(img1, q[..., None, :] + offs) - I0
        bx = torch.sum(dI * Ix, dim=-1)
        by = torch.sum(dI * Iy, dim=-1)
        q = q - torch.stack([i00 * bx + i01 * by, i10 * bx + i11 * by], dim=-1)
    return q


def pyr_lk(
    img0: torch.Tensor,  # (*B, H, W) float32 source frame
    img1: torch.Tensor,  # (*B, H, W) target frame
    p0: torch.Tensor,  # (*B, N, 2) points in img0
    p1_init: torch.Tensor,  # (*B, N, 2) initial guesses in img1 (e.g. rotation-warped)
    n_levels: int = 3,
    n_iters: int = 8,
):
    """Track p0 from img0 into img1, coarse to fine over a factor-2 pyramid
    of `n_levels`, `n_iters` LK updates a level. Returns (p1 (*B, N, 2),
    ok (*B, N)): ok where p1 lies at least WIN px inside the image and the
    mean absolute difference of the 5x5 patches around p0 and p1 is under
    12 grey levels."""
    pyr0 = build_pyramid(img0, n_levels, 2.0)
    pyr1 = build_pyramid(img1, n_levels, 2.0)
    cur = p1_init / 2.0 ** (n_levels - 1)
    for l in range(n_levels - 1, -1, -1):
        gx0, gy0 = sobel_gradients(pyr0[l])
        cur = _lk_level(pyr0[l], pyr1[l], gx0, gy0, p0 / 2.0**l, cur, n_iters)
        if l > 0:
            cur = cur * 2.0
    h, w = img0.shape[-2:]
    x, y = cur[..., 0], cur[..., 1]
    inb = (x >= WIN) & (x < w - WIN) & (y >= WIN) & (y < h - WIN)
    offs = _offsets(2, p0.device)
    err = torch.mean(torch.abs(
        bilinear_sample(img1, cur[..., None, :] + offs) - bilinear_sample(img0, p0[..., None, :] + offs)
    ), dim=-1)
    return cur, inb & (err < 12.0)


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


def recover_line_by_flow(
    intr: Intrinsics,
    img0: torch.Tensor,  # (H, W) previous frame
    img1: torch.Tensor,  # (H, W) current frame
    p0_seg: torch.Tensor,  # (2,) line endpoint A in img0
    p1_seg: torch.Tensor,  # (2,) endpoint B
    R_10: torch.Tensor,  # (3, 3) rotation prior (cam1 <- cam0)
    n_pts: int = 16,
):
    """Track one line segment into the next frame by rotation-seeded LK and
    refit it (reference: optical_flow_line's sample -> warp -> LK -> line
    refit, src/LSDmatcher.cpp:158-520): `n_pts` samples along the segment,
    seeded by `warp_points_by_rotation`, tracked by `pyr_lk`, and a weighted
    PCA line through those tracked ok. Returns (q0 (2,), q1 (2,), ok ()):
    ok where at least max(n_pts // 2, 5) tracked samples lie within 2.5 px
    of the line and the extent is not empty."""
    dev = p0_seg.device
    ts = (torch.arange(n_pts, device=dev).float() + 0.5) / n_pts
    pts = p0_seg[None, :] + (p1_seg - p0_seg)[None, :] * ts[:, None]
    tracked, ok = pyr_lk(img0, img1, pts, warp_points_by_rotation(intr, pts, R_10))
    wgt = ok.float()
    sw = torch.sum(wgt) + 1e-9
    c = torch.sum(tracked * wgt[:, None], dim=0) / sw
    d = tracked - c
    cxx = torch.sum(wgt * d[:, 0] * d[:, 0]) / sw
    cyy = torch.sum(wgt * d[:, 1] * d[:, 1]) / sw
    cxy = torch.sum(wgt * d[:, 0] * d[:, 1]) / sw
    phi = 0.5 * torch.atan2(2 * cxy, cxx - cyy)
    u = torch.stack([torch.cos(phi), torch.sin(phi)])
    along = d @ u
    big = torch.tensor(1e9, device=dev)
    a_min = torch.min(torch.where(ok, along, big))
    a_max = torch.max(torch.where(ok, along, -big))
    # Line fit residual gate (reference: point-line distance tiers of
    # 0.1 ... 2.5 px, src/LSDmatcher.cpp:420-470).
    perp = torch.abs(d @ torch.stack([-u[1], u[0]]))
    good_fit = torch.sum((perp < 2.5) & ok) >= max(n_pts // 2, 5)
    return c + u * a_min, c + u * a_max, good_fit & (a_max > a_min)
