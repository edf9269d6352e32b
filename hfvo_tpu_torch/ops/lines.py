"""Line segment detection + band descriptors.

Port of `hfvo_tpu.ops.lines` (which replaces the reference's LSD detector
and binary LBD descriptor, Thirdparty/line_descriptor, src/LineExtractor.cpp):

1. Sobel gradients; each pixel with magnitude above `mag_th` votes in its
   64x64 tile's (theta, rho) accumulator: its magnitude into its own
   line-normal bin and half of it into the two neighbouring bins (mod 36),
   at rho taken against the target bin's theta.
2. The top 4 accumulator peaks per tile become candidate infinite lines.
3. Each candidate's aligned pixels near the line give its extent by a
   weighted PCA, with support and length gates.
4. Collinear merging replicates `Frame::cullingLine` (src/Frame.cc:952-1115).
5. Band descriptors (a float LBD-style statistic), canonically oriented so
   that the mean perpendicular gradient is positive.

`hough_vote` owns kernel K3 (`csrc/hough_vote.cu`, the port of
`hfvo_tpu/ops/pallas_hough.py::_kernel`), and on an (S, H, W) stack its
batched launch K3b (the `custom_vmap` rule of `pallas_hough.py:116-129`).
It computes the float32 vote of the JAX package's CPU scan
(`hfvo_tpu/ops/lines.py:116-145`), not the TPU kernel's bf16 one-hot
matmul. A CPU tensor takes its plain version `hough_vote_reference`; a CUDA
tensor launches the kernel or raises. Every function here also takes a
leading sequence axis.

Ties follow the JAX package: `jax.lax.top_k` becomes a stable descending
sort (lower index first among equals), `jnp.argmax` `torch.argmax` (first
maximum), `%` `torch.remainder` (floor-mod).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .batch import gather_pixels, take_rows
from .image import sobel_gradients

TILE = 64
N_THETA = 36
N_RHO = 48  # rho resolution over the tile diagonal
DESC_BANDS = 9
DESC_SAMPLES = 16
DIAG = TILE * math.sqrt(2.0)

# Launches by `hough_vote`, one per call on a CUDA tensor whatever S is:
# K3 on an (H, W) image, K3b on an (S, H, W) stack. Read and reset by
# callers that check a path used them.
hough_vote_launches = 0  # K3
hough_vote_batched_launches = 0  # K3b

# C interface of csrc/hough_vote.cu: (mag, ang, table, out, S, H, W, mag_th,
# stream) -> cudaError_t.
_HOUGH_SIGNATURES = {
    "hfvo_hough_vote": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    ),
}


def theta_table() -> np.ndarray:
    """(2, N_THETA) float32 [cos; sin] of the theta bin centres
    (t + 0.5) / N_THETA * pi, with the angle rounded to float32 as the JAX
    package computes it and the cosine and sine correctly rounded to
    float32. The kernel and its plain version read this one table."""
    th = (np.arange(N_THETA, dtype=np.float32) + np.float32(0.5)) / np.float32(N_THETA)
    th = (th * np.float32(np.pi)).astype(np.float64)
    return np.stack([np.cos(th), np.sin(th)]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _table_on(device: str) -> torch.Tensor:
    return torch.from_numpy(theta_table()).to(device)


class LineFeatures(NamedTuple):
    """Fixed-capacity per-frame line segments (level-0 pixel coords);
    batched, every leaf has a leading (S,) axis."""

    p0: torch.Tensor  # (M, 2) endpoint (x, y)
    p1: torch.Tensor  # (M, 2)
    angle: torch.Tensor  # (M,) direction angle in [-pi, pi)
    response: torch.Tensor  # (M,) support strength
    desc: torch.Tensor  # (M, D) float32, L2-normalized
    valid: torch.Tensor  # (M,)

    @property
    def length(self) -> torch.Tensor:
        return torch.linalg.norm(self.p1 - self.p0, dim=-1)

    @property
    def line2d(self) -> torch.Tensor:
        """Normalized infinite-line coefficients (a, b, c): a*u + b*v + c = 0."""
        d = self.p1 - self.p0
        n = torch.stack([-d[..., 1], d[..., 0]], dim=-1)
        n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-9)
        c = -torch.sum(n * self.p0, dim=-1)
        return torch.cat([n, c[..., None]], dim=-1)


def to_tiles(a: torch.Tensor) -> torch.Tensor:
    """(*B, H, W) -> (*B, T, TILE*TILE): whole tiles in row-major tile
    order, pixels row-major inside a tile; the ragged right and bottom edges
    are dropped."""
    batch = a.shape[:-2]
    H, W = a.shape[-2:]
    ty, tx = H // TILE, W // TILE
    return (
        a[..., : ty * TILE, : tx * TILE]
        .reshape(batch + (ty, TILE, tx, TILE))
        .transpose(-3, -2)
        .reshape(batch + (ty * tx, TILE * TILE))
    )


def _local_xy(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xl, yl) float32 (TILE*TILE,) pixel coordinates inside a tile."""
    p = torch.arange(TILE * TILE, device=device)
    return (p % TILE).float(), (p // TILE).float()


def _theta_bin(normal_ang: torch.Tensor) -> torch.Tensor:
    return torch.clamp((normal_ang / math.pi * N_THETA).to(torch.int32), 0, N_THETA - 1).long()


def _rho_bin(rho: torch.Tensor) -> torch.Tensor:
    return torch.clamp(((rho / DIAG + 1.0) * 0.5 * N_RHO).to(torch.int32), 0, N_RHO - 1).long()


def hough_vote_reference(
    mag: torch.Tensor, normal_ang: torch.Tensor, mag_th: float
) -> torch.Tensor:
    """Plain version of kernels K3 and K3b: (*B, H, W) gradient magnitude
    and line-normal angle in [0, pi) -> (*B, T, N_THETA, N_RHO) float32
    per-tile accumulators, T = (H // 64) * (W // 64) in row-major tile
    order.

    Each pixel with mag > mag_th adds mag at (theta_bin, rho_bin) and mag/2
    at each neighbouring theta row (mod N_THETA), rho taken against the
    target row's centre angle (the scan of hfvo_tpu/ops/lines.py:116-145).
    The tiles of every batch element are one list here: tile k of element
    s is accumulator s * T + k of the flat scatter."""
    batch = mag.shape[:-2]
    m_t = to_tiles(mag).reshape(-1, TILE * TILE)
    na_t = to_tiles(normal_ang).reshape(-1, TILE * TILE)
    T = m_t.shape[0]
    dev = mag.device
    table = _table_on(str(dev))
    xl, yl = _local_xy(dev)
    tb = _theta_bin(na_t)
    w = torch.where(m_t > mag_th, m_t, torch.zeros_like(m_t))
    tile = torch.arange(T, device=dev)[:, None] * (N_THETA * N_RHO)
    acc = torch.zeros(T * N_THETA * N_RHO, dtype=torch.float32, device=dev)
    for delta, scale in ((0, 1.0), (-1, 0.5), (1, 0.5)):
        t = torch.remainder(tb + delta, N_THETA)
        rho = xl * table[0][t] + yl * table[1][t]
        idx = tile + t * N_RHO + _rho_bin(rho)
        acc.index_add_(0, idx.reshape(-1), (w * scale).reshape(-1))
    return acc.reshape(batch + (-1, N_THETA, N_RHO))


def hough_vote(mag: torch.Tensor, normal_ang: torch.Tensor, mag_th: float) -> torch.Tensor:
    """Per-tile Hough accumulators (kernel K3 on an (H, W) CUDA image, K3b
    on an (S, H, W) stack, one launch for the stack); see
    `hough_vote_reference` for what it computes.

    mag, normal_ang: float32, contiguous, on one device. A CPU tensor goes
    to the plain version; a CUDA tensor goes to the kernel."""
    global hough_vote_launches, hough_vote_batched_launches
    if mag.device.type == "cpu":
        return hough_vote_reference(mag, normal_ang, mag_th)
    if mag.device.type != "cuda":
        raise ValueError(f"hough_vote: unsupported device {mag.device}")
    for name, a in (("mag", mag), ("normal_ang", normal_ang)):
        if a.dtype != torch.float32 or a.dim() not in (2, 3) or not a.is_contiguous():
            raise ValueError(
                f"hough_vote: {name} must be a contiguous (H, W) or (S, H, W) float32 "
                f"tensor, got {a.dtype} of shape {tuple(a.shape)}"
            )
    if normal_ang.shape != mag.shape or normal_ang.device != mag.device:
        raise ValueError("hough_vote: mag and normal_ang differ in shape or device")
    s, (h, w) = (mag.shape[0] if mag.dim() == 3 else 1), mag.shape[-2:]
    out = torch.empty(mag.shape[:-2] + ((h // TILE) * (w // TILE), N_THETA, N_RHO),
                      dtype=torch.float32, device=mag.device)
    if out.numel() == 0:
        return out
    from . import _kernels

    lib = _kernels.load("hough_vote", _HOUGH_SIGNATURES)
    table = _table_on(str(mag.device))
    with torch.cuda.device(mag.device):
        stream = torch.cuda.current_stream(mag.device).cuda_stream
        err = lib.hfvo_hough_vote(
            ctypes.c_void_p(mag.data_ptr()), ctypes.c_void_p(normal_ang.data_ptr()),
            ctypes.c_void_p(table.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            s, h, w, float(mag_th), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"hough_vote kernel launch failed: {_kernels.error_string(lib, err)}")
    if mag.dim() == 3:
        hough_vote_batched_launches += 1
    else:
        hough_vote_launches += 1
    return out


def _tile_hough(gray: torch.Tensor, mag_th: float):
    """Per-tile Hough accumulation. Returns (acc (*B, T, N_THETA, N_RHO),
    tile origins (T, 2) as (x, y), gx, gy, mag, normal_ang)."""
    H, W = gray.shape[-2:]
    gx, gy = sobel_gradients(gray)
    mag = torch.sqrt(gx * gx + gy * gy)
    # Line-normal angle of each pixel = gradient direction (mod pi).
    normal_ang = torch.remainder(torch.atan2(gy, gx), math.pi)
    acc = hough_vote(mag, normal_ang, mag_th)
    ty, tx = H // TILE, W // TILE
    r = torch.arange(ty * tx, device=gray.device)
    origins = torch.stack([(r % tx) * TILE, (r // tx) * TILE], dim=1).float()
    return acc, origins, gx, gy, mag, normal_ang


def _topk_stable(x: torch.Tensor, k: int):
    """`jax.lax.top_k` along the last axis: descending, lower index first
    among equal values."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def detect_lines(
    gray: torch.Tensor,
    peaks_per_tile: int = 4,
    capacity: int = 256,
    mag_th: float = 12.0,
    min_support: float = 20.0,
    min_length: float = 20.0,
) -> LineFeatures:
    """Detect line segments in an (H, W) float32 image, or in each image of
    an (S, H, W) stack -> fixed-capacity LineFeatures
    (hfvo_tpu/ops/lines.py:151-273)."""
    batch = gray.shape[:-2]
    acc, origins, gx, gy, mag, normal_ang = _tile_hough(gray, mag_th)
    T = acc.shape[-3]
    dev = gray.device
    top_v, top_i = _topk_stable(acc.reshape(batch + (T, -1)), peaks_per_tile)  # (*B, T, P)
    tb = top_i // N_RHO
    rb = top_i % N_RHO
    theta = (tb.float() + 0.5) / N_THETA * math.pi  # line normal
    rho = (rb.float() / N_RHO * 2.0 - 1.0) * DIAG + DIAG / N_RHO

    # Every peak of tile t reduces over tile t's own pixels: (T, P, TILE^2).
    table = _table_on(str(dev))
    ct, st = table[0][tb][..., None], table[1][tb][..., None]
    xl, yl = _local_xy(dev)
    ms = to_tiles(mag)[..., None, :]
    nas = to_tiles(normal_ang)[..., None, :]
    th_c, rho_c = theta[..., None], rho[..., None]
    d_perp = xl * ct + yl * st - rho_c
    ang_diff = torch.abs(torch.remainder((nas - th_c) + math.pi / 2, math.pi) - math.pi / 2)
    # Gate width covers the Hough rho quantization (diag/N_RHO ~ 1.9 px
    # half-bin); the PCA refit below recovers sub-pixel placement.
    support = (torch.abs(d_perp) < 2.5) & (ang_diff < math.pi / N_THETA * 1.5) & (ms > mag_th)
    w = torch.where(support, ms, torch.zeros_like(ms))
    sw = torch.sum(w, dim=-1) + 1e-9
    cx = torch.sum(w * xl, dim=-1) / sw
    cy = torch.sum(w * yl, dim=-1) / sw
    dxs = xl - cx[..., None]
    dys = yl - cy[..., None]
    cxx = torch.sum(w * dxs * dxs, dim=-1) / sw
    cyy = torch.sum(w * dys * dys, dim=-1) / sw
    cxy = torch.sum(w * dxs * dys, dim=-1) / sw
    # Principal direction of the weighted support (2x2 closed form).
    phi = 0.5 * torch.atan2(2 * cxy, cxx - cyy)
    ux, uy = torch.cos(phi), torch.sin(phi)
    along = dxs * ux[..., None] + dys * uy[..., None]
    big = torch.tensor(1e9, device=dev)
    a_min = torch.min(torch.where(support, along, big), dim=-1).values
    a_max = torch.max(torch.where(support, along, -big), dim=-1).values
    n_sup = torch.sum(support.float(), dim=-1)
    ok = (n_sup >= min_support) & (a_max - a_min >= min_length)
    p0 = (torch.stack([cx + a_min * ux, cy + a_min * uy], dim=-1) + origins[:, None, :])
    p1 = (torch.stack([cx + a_max * ux, cy + a_max * uy], dim=-1) + origins[:, None, :])
    p0, p1 = p0.reshape(batch + (-1, 2)), p1.reshape(batch + (-1, 2))
    strength = sw.reshape(batch + (-1,))
    ok = ok.reshape(batch + (-1,))

    # Pad/trim to capacity by strength.
    n_cand = p0.shape[-2]
    score = torch.where(ok, strength, torch.full_like(strength, -1.0))
    k = min(capacity, n_cand)
    top_s, sel = _topk_stable(score, k)
    p0, p1 = take_rows(p0, sel), take_rows(p1, sel)
    valid = top_s > 0
    if k < capacity:
        p0 = torch.nn.functional.pad(p0, (0, 0, 0, capacity - k))
        p1 = torch.nn.functional.pad(p1, (0, 0, 0, capacity - k))
        top_s = torch.nn.functional.pad(top_s, (0, capacity - k))
        valid = torch.nn.functional.pad(valid, (0, capacity - k))

    p0, p1, valid = merge_collinear(p0, p1, torch.where(valid, top_s, torch.zeros_like(top_s)), valid)
    # Canonical orientation: flip endpoints so the centre band's mean
    # perpendicular gradient is positive. Under an endpoint swap the band
    # sample points are the same, so the flipped descriptor is a permutation
    # of the unflipped one: bands reversed, (par+, par-) and (perp+, perp-)
    # swapped.
    desc_raw = band_descriptors(gray, gx, gy, p0, p1)
    db = desc_raw.reshape(desc_raw.shape[:-1] + (DESC_BANDS, 4))
    flip = (db[..., DESC_BANDS // 2, 2] - db[..., DESC_BANDS // 2, 3]) < 0
    desc_flipped = db.flip(-2)[..., [1, 0, 3, 2]].reshape(desc_raw.shape)
    desc = torch.where(flip[..., None], desc_flipped, desc_raw)
    p0_c = torch.where(flip[..., None], p1, p0)
    p1_c = torch.where(flip[..., None], p0, p1)
    d = p1_c - p0_c
    angle = torch.atan2(d[..., 1], d[..., 0])  # full [-pi, pi): direction-aware
    return LineFeatures(
        p0_c, p1_c, angle, torch.where(valid, top_s, torch.zeros_like(top_s)), desc, valid
    )


def merge_collinear(
    p0: torch.Tensor,
    p1: torch.Tensor,
    strength: torch.Tensor,
    valid: torch.Tensor,
    ang_th: float = 0.05,
    dist_th: float = 2.5,
    gap_th: float = 12.0,
    n_iters: int = 3,
):
    """Merge collinear/overlapping segments (reference: Frame::cullingLine,
    src/Frame.cc:952). Each iteration computes the pairwise merge gates; a
    segment absorbed by a stronger collinear partner that has no stronger
    partner itself extends that partner and is invalidated. Inputs
    (*B, M, ...): each batch element merges its own segments."""
    M = p0.shape[-2]
    dev = p0.device
    idx = torch.arange(M, device=dev)
    eye = torch.eye(M, dtype=torch.bool, device=dev)
    ninf = torch.tensor(-math.inf, device=dev)
    for _ in range(n_iters):
        d = p1 - p0
        length = torch.linalg.norm(d, dim=-1) + 1e-9
        u = d / length[..., None]
        mid = 0.5 * (p0 + p1)
        cosang = torch.abs(u @ u.transpose(-1, -2))
        ang_ok = cosang > math.cos(ang_th)
        # Perp distance of j's midpoint to line i.
        n_i = torch.stack([-u[..., 1], u[..., 0]], dim=-1)
        dperp = torch.abs(n_i @ mid.transpose(-1, -2) - torch.sum(n_i * p0, dim=-1)[..., None])
        dist_ok = dperp < dist_th
        # Along-line gap between segments (projections onto i's direction).
        t0 = u @ p0.transpose(-1, -2) - torch.sum(u * p0, dim=-1)[..., None]
        t1 = u @ p1.transpose(-1, -2) - torch.sum(u * p0, dim=-1)[..., None]
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        gap = torch.maximum(lo - length[..., None], -hi)  # >0 -> separated
        gap_ok = gap < gap_th
        both = valid[..., :, None] & valid[..., None, :]
        mergeable = ang_ok & dist_ok & gap_ok & both & ~eye
        # Strict strength order (ties by index) to rank partners.
        s_i, s_j = strength[..., :, None], strength[..., None, :]
        stronger = mergeable & ((s_i > s_j) | ((s_i == s_j) & (idx[:, None] < idx[None, :])))
        is_top = ~torch.any(stronger, dim=-2)
        can_absorb = stronger & is_top[..., :, None]
        absorber = torch.argmax(torch.where(can_absorb, s_i, ninf), dim=-2)
        absorbed = torch.any(can_absorb, dim=-2)
        absorb = can_absorb & (absorber[..., None, :] == idx[:, None])
        zero = torch.zeros_like(lo)
        ext_lo = torch.min(torch.where(absorb, lo, zero), dim=-1).values
        ext_hi = torch.max(torch.where(absorb, hi, length[..., None].expand_as(hi)), dim=-1).values
        ext_lo = torch.clamp(ext_lo, max=0.0)
        ext_hi = torch.maximum(ext_hi, length)
        new_p0 = p0 + u * ext_lo[..., None]
        new_p1 = p0 + u * ext_hi[..., None]
        gains = torch.zeros_like(strength).scatter_add_(
            -1, absorber, torch.where(absorbed, strength, torch.zeros_like(strength))
        )
        p0, p1 = new_p0, new_p1
        strength = strength + gains
        valid = valid & ~absorbed
    return p0, p1, valid


def band_descriptors(
    gray: torch.Tensor,
    gx: torch.Tensor,
    gy: torch.Tensor,
    p0: torch.Tensor,
    p1: torch.Tensor,
) -> torch.Tensor:
    """LBD-style band gradient statistics -> (*B, M, 4 * DESC_BANDS) float32.

    DESC_BANDS strips parallel to the segment (perpendicular offsets -4..4
    px) x DESC_SAMPLES points along it, read at the nearest pixel; per band
    the means of (g_par+, g_par-, g_perp+, g_perp-)
    (binary_descriptor_custom.cpp band layout). L2-normalized for cosine
    matching."""
    dev = p0.device
    d = p1 - p0
    length = torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-9
    u = d / length  # along
    n = torch.stack([-u[..., 1], u[..., 0]], dim=-1)  # perpendicular
    ts = (torch.arange(DESC_SAMPLES, device=dev).float() + 0.5) / DESC_SAMPLES
    offs = torch.arange(DESC_BANDS, device=dev).float() - (DESC_BANDS - 1) / 2.0
    base = p0[..., None, None, :] + d[..., None, None, :] * ts[None, :, None]
    pts = base + n[..., None, None, :] * offs[:, None, None]  # (*B, M, bands, samples, 2)
    h, w = gray.shape[-2:]
    xr = torch.clamp(torch.round(pts[..., 0]).long(), 0, w - 1)
    yr = torch.clamp(torch.round(pts[..., 1]).long(), 0, h - 1)
    gxs = gather_pixels(gx, yr, xr)
    gys = gather_pixels(gy, yr, xr)
    g_par = gxs * u[..., 0, None, None] + gys * u[..., 1, None, None]
    g_perp = gxs * n[..., 0, None, None] + gys * n[..., 1, None, None]
    feats = torch.stack(
        [
            torch.mean(torch.clamp(g_par, min=0.0), dim=-1),
            torch.mean(torch.clamp(-g_par, min=0.0), dim=-1),
            torch.mean(torch.clamp(g_perp, min=0.0), dim=-1),
            torch.mean(torch.clamp(-g_perp, min=0.0), dim=-1),
        ],
        dim=-1,
    )  # (*B, M, bands, 4)
    desc = feats.reshape(feats.shape[:-2] + (DESC_BANDS * 4,))
    return desc / (torch.linalg.norm(desc, dim=-1, keepdim=True) + 1e-9)


def line_distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Cosine distance in [0, 2] between band descriptors."""
    return 1.0 - desc_a @ desc_b.transpose(-1, -2)
