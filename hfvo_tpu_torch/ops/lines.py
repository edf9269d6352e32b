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
tensor launches the kernel or raises. The kernel's bins have no division;
`theta_bin_kernel` and `rho_bin_kernel` mirror them on the CPU, where they
are held equal to the plain version's. Every function here also takes a
leading sequence axis.

Ties follow the JAX package: `jax.lax.top_k` becomes a stable descending
sort (lower index first among equals), `jnp.argmax` `torch.argmax` (first
maximum), `%` `torch.remainder` (floor-mod).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _kernels
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

# C interface of csrc/hough_vote.cu: the launch (mag, ang, table, out, S,
# H, W, mag_th, stream) and its shape (S, H, W, int[6]), each ->
# cudaError_t.
_HOUGH_SIGNATURES = {
    "hfvo_hough_vote": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    ),
    "hfvo_hough_launch_shape": (
        ctypes.c_int, [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
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


# The kernel's first guess at a theta bin is int(angle * THETA_SCALE); its
# rho bin is int(rho * RHO_SCALE + N_RHO / 2) (csrc/hough_vote.cu).
THETA_SCALE = np.float32(N_THETA / math.pi)
RHO_SCALE = np.float32(0.5 * N_RHO / DIAG)


@functools.lru_cache(maxsize=None)
def theta_edges() -> np.ndarray:
    """(N_THETA + 1,) float32: entry k is the least float32 angle whose
    plain-version theta bin (`_theta_bin`) is >= k, with -inf and +inf at
    k = 0 and N_THETA. Found by bisection over float32 order, which holds
    because the plain bin is monotone in the angle: dividing by pi,
    multiplying by N_THETA and truncating each keep the order."""
    k = np.arange(1, N_THETA)
    # Bit patterns of positive float32s order as the floats do: bin(0) = 0 < k
    # and bin(4) = N_THETA - 1 >= k.
    lo = np.zeros(N_THETA - 1, np.int64)
    hi = np.full(N_THETA - 1, int(np.float32(4.0).view(np.int32)), np.int64)
    while (hi - lo > 1).any():
        mid = lo + (hi - lo) // 2
        at = torch.from_numpy(mid.astype(np.int32).view(np.float32))
        ge = _theta_bin(at).numpy() >= k
        hi, lo = np.where(ge, mid, hi), np.where(ge, lo, mid)
    inner = hi.astype(np.int32).view(np.float32)
    return np.concatenate([[-np.inf], inner, [np.inf]]).astype(np.float32)


def kernel_table() -> np.ndarray:
    """(3 * N_THETA + 1,) float32 table of csrc/hough_vote.cu: the cosines
    and the sines of `theta_table`, then `theta_edges`."""
    return np.concatenate([theta_table().ravel(), theta_edges()])


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


def theta_bin_kernel(normal_ang: torch.Tensor) -> torch.Tensor:
    """Plain mirror of the kernel's theta bin, which has no division: the
    guess int(angle * THETA_SCALE), clamped, corrected by one step against
    `theta_edges`, and kept in range. Equals `_theta_bin` on every finite
    angle (tests/test_torch_hough.py)."""
    edges = torch.from_numpy(theta_edges()).to(normal_ang.device)
    tb = torch.clamp((normal_ang * float(THETA_SCALE)).to(torch.int32), 0, N_THETA - 1).long()
    tb = tb - (normal_ang < edges[tb]).long() + (normal_ang >= edges[tb + 1]).long()
    return torch.clamp(tb, max=N_THETA - 1)


def rho_bin_kernel(rho: torch.Tensor) -> torch.Tensor:
    """Plain mirror of the kernel's rho bin, int(rho * RHO_SCALE + 24)
    clamped, with each step rounded (no FMA). Equals `_rho_bin` wherever rho
    is x cos + y sin of integer tile coordinates and a table row."""
    return torch.clamp((rho * float(RHO_SCALE) + N_RHO // 2).to(torch.int32), 0, N_RHO - 1).long()


def vote_bins(normal_ang: torch.Tensor, theta_bin=_theta_bin, rho_bin=_rho_bin):
    """The (theta row, rho bin) of each of a pixel's three votes, own row
    first, then row - 1 and row + 1 (mod N_THETA), for (*B, TILE*TILE)
    tiles of line-normal angle; rho at the target row's centre."""
    table = _table_on(str(normal_ang.device))
    xl, yl = _local_xy(normal_ang.device)
    tb = theta_bin(normal_ang)
    out = []
    for delta in (0, -1, 1):
        t = torch.remainder(tb + delta, N_THETA)
        out.append((t, rho_bin(xl * table[0][t] + yl * table[1][t])))
    return out


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
    w = torch.where(m_t > mag_th, m_t, torch.zeros_like(m_t))
    tile = torch.arange(T, device=dev)[:, None] * (N_THETA * N_RHO)
    acc = torch.zeros(T * N_THETA * N_RHO, dtype=torch.float32, device=dev)
    for (t, rb), scale in zip(vote_bins(na_t), (1.0, 0.5, 0.5)):
        idx = tile + t * N_RHO + rb
        acc.index_add_(0, idx.reshape(-1), (w * scale).reshape(-1))
    return acc.reshape(batch + (-1, N_THETA, N_RHO))


# Per CUDA device index: the library of csrc/hough_vote.cu and its table
# on that device, made at the first launch there.
_launchers: Dict[int, Tuple[ctypes.CDLL, torch.Tensor]] = {}


def _launcher(index: int) -> Tuple[ctypes.CDLL, torch.Tensor]:
    got = _launchers.get(index)
    if got is None:
        lib = _kernels.load("hough_vote", _HOUGH_SIGNATURES)
        table = torch.from_numpy(kernel_table()).to(torch.device("cuda", index))
        got = _launchers[index] = (lib, table)
    return got


def _launch(mag: torch.Tensor, normal_ang: torch.Tensor, mag_th: float,
            lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """One launch of csrc/hough_vote.cu (or of `lib`, a library built from a
    variant of it) on checked CUDA inputs; raises on a failed launch."""
    s, (h, w) = (mag.shape[0] if mag.dim() == 3 else 1), mag.shape[-2:]
    out = torch.empty(mag.shape[:-2] + ((h // TILE) * (w // TILE), N_THETA, N_RHO),
                      dtype=torch.float32, device=mag.device)
    if out.numel() == 0:
        return out
    index = mag.device.index
    own, table = _launcher(index)
    lib = lib or own
    args = (mag.data_ptr(), normal_ang.data_ptr(), table.data_ptr(), out.data_ptr(), s, h, w,
            float(mag_th))
    here = torch.cuda.current_device() == index
    with contextlib.nullcontext() if here else torch.cuda.device(index):
        err = lib.hfvo_hough_vote(*args, torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hough_vote kernel launch failed: {_kernels.error_string(lib, err)}")
    return out


def launch_shape(s: int, h: int, w: int, device=None,
                 lib: Optional[ctypes.CDLL] = None) -> Dict[str, int]:
    """The kernel's launch (or that of `lib`, a variant) for s (h, w) images
    on a CUDA device: cluster size, threads a block, grid, and the most
    clusters the card holds at once."""
    index = torch.device(device or "cuda").index
    if index is None:
        index = torch.cuda.current_device()
    lib = lib or _launcher(index)[0]
    shape = (ctypes.c_int * 6)()
    with torch.cuda.device(index):
        err = lib.hfvo_hough_launch_shape(s, h, w, shape)
    if err != 0:
        raise RuntimeError(f"hough_vote launch shape: {_kernels.error_string(lib, err)}")
    return dict(zip(("cluster", "threads", "grid_x", "grid_y", "grid_z", "max_active_clusters"), shape))


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
    out = _launch(mag, normal_ang, mag_th)
    if out.numel() == 0:
        return out
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
