"""The benchmark's one traffic generator: looped synthetic RGB-D sequences.

A traffic mix is a JSON file under `hfvo_bench/traffic/` that this module
reads: the room (textured or low-texture), the camera path, the sensor model
and how several sequences share one rendered period. Nothing here imports
the program: the renderer is a frozen copy of
`hfvo_tpu_torch.testing.synthetic` at commit ccf1f66 (`make_room_textures`,
`render` of the box room, `orbit_trajectory`, and the cubic resize and SO(3)
exponential they call), so a later change to the program cannot change the
inputs. `hfvo_bench/tests/test_hfvo_bench_traffic.py` holds the copy to the
original.

The orbit's terms are sin(a), sin(2a) and sin(a / 2) of the angle a = step
* i, so with step = 0.3 pi / 24 the path repeats every 320 frames exactly:
the generator renders one period once, in set-up, and sequence s reads frame
(phase + s * stride + i) mod period, so no run can exhaust its input and
the camera path is continuous across the wrap.

A mix names its room (`room.texture_seed`) and the phase at which the
first sequence starts (`trajectory.phase`), so every seed drives the same
scene and path and does the same work; the seed draws the sensor noise.

The sensor model is `hfvo_tpu_torch.testing.endurance.sensorize` (uint8
gray, uint16 millimetre depth with Kinect axial noise sigma = quad_sigma *
z^2 and elliptical dropout holes), drawn on the device from one
`torch.Generator` seeded by the run's seed, in bulk.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
import torch

# Room half-extents (m) and texture resolution of the frozen renderer.
HX, HY, HZ = 3.0, 2.0, 3.0
TEX = 512
_FACES = [(0, +1), (0, -1), (1, +1), (1, -1), (2, +1), (2, -1)]
_EXTENT = [HX, HX, HY, HY, HZ, HZ]
_UVAXES = [(1, 2), (1, 2), (0, 2), (0, 2), (0, 1), (0, 1)]
_UVSPAN = [(HY, HZ), (HY, HZ), (HX, HZ), (HX, HZ), (HX, HY), (HX, HY)]


# ---- frozen cubic resize (hfvo_tpu_torch/ops/image.py, `jax.image.resize`) ----

def _fma(a, b, c) -> np.ndarray:
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = _fma((_fma(1.5, x, -2.5) * x).astype(np.float32), x, 1.0)
    out = np.where(x >= 1.0, _fma(_fma(_fma(-0.5, x, 2.5), x, -4.0), x, 2.0), out)
    return np.where(x >= 2.0, np.float32(0), out).astype(np.float32)


def _cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x.astype(np.float32)).astype(np.float32)
    total = np.sum(w, axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, np.float32(0)).astype(np.float32).T)


def _cubic_up(coarse: np.ndarray) -> np.ndarray:
    img = torch.from_numpy(coarse)
    h, w = img.shape
    out = torch.from_numpy(_cubic_weights(h, TEX)) @ img
    out = out @ torch.from_numpy(_cubic_weights(w, TEX)).T
    return out.numpy().copy()


def make_room_textures(seed: int, stripes: bool = True, low_texture: bool = False) -> np.ndarray:
    """(6, TEX, TEX) float32 textures in [0, 255], as the program's
    `synthetic.make_room_textures`."""
    rng = np.random.RandomState(seed)
    texs = []
    for _ in range(6):
        if low_texture:
            t = _cubic_up(rng.uniform(120, 150, size=(4, 4)).astype(np.float32))
        else:
            t = _cubic_up(rng.uniform(60, 200, size=(TEX // 32, TEX // 32)).astype(np.float32))
            for _ in range(120):
                cy, cx = rng.randint(8, TEX - 8, size=2)
                s = rng.randint(3, 9)
                t[cy: cy + s, cx: cx + s] = rng.choice([15.0, 240.0])
        if stripes:
            for _ in range(6):
                pos = rng.randint(30, TEX - 30)
                wdt = rng.randint(4, 8)
                if rng.rand() < 0.5:
                    t[pos: pos + wdt, :] = 20.0
                else:
                    t[:, pos: pos + wdt] = 20.0
        texs.append(np.clip(t, 0, 255))
    return np.stack(texs).astype(np.float32)


# ---- frozen SO(3) exponential (hfvo_tpu_torch/geometry/se3.py) ----

def _hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1), torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    big = theta2 > 1e-8
    t2 = torch.where(big, theta2, torch.ones_like(theta2))
    t = torch.sqrt(t2)
    a = torch.where(big, torch.sin(t) / t, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(t)) / t2, 0.5 - theta2 / 24.0)
    W = _hat(w)
    eye = torch.eye(3, dtype=W.dtype).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def orbit_trajectory(n: int, radius: float = 0.6, yaw_amp: float = 0.35,
                     center=(0.0, 0.0, -0.8), step: float = 0.3 * np.pi / 24.0) -> np.ndarray:
    """(n, 4, 4) float32 camera-to-world poses of the program's
    `synthetic.orbit_trajectory`."""
    out = []
    for i in range(n):
        ang = step * i
        t = np.array([center[0] + radius * np.sin(ang), center[1] + 0.15 * np.sin(2 * ang),
                      center[2] + 0.3 * np.sin(ang * 0.5)], np.float32)
        yaw = yaw_amp * np.sin(ang)
        pitch = 0.08 * np.sin(2 * ang)
        Rz = exp_so3(torch.tensor([0.0, yaw, 0.0], dtype=torch.float32)).numpy()
        Rx = exp_so3(torch.tensor([pitch, 0.0, 0.0], dtype=torch.float32)).numpy()
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rz @ Rx
        T[:3, 3] = t
        out.append(T)
    return np.stack(out)


def _bilinear(tex: torch.Tensor, tu: torch.Tensor, tv: torch.Tensor) -> torch.Tensor:
    x0 = torch.clamp(torch.floor(tu).long(), 0, TEX - 2)
    y0 = torch.clamp(torch.floor(tv).long(), 0, TEX - 2)
    fx = torch.clamp(tu - x0, 0.0, 1.0)
    fy = torch.clamp(tv - y0, 0.0, 1.0)
    return (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x0 + 1] * fx * (1 - fy)
            + tex[y0 + 1, x0] * (1 - fx) * fy + tex[y0 + 1, x0 + 1] * fx * fy)


def render(textures: torch.Tensor, cam: dict, T_wc: torch.Tensor):
    """(gray (H, W), depth (H, W)) float32 of the box room seen from T_wc,
    on the textures' device: the program's `synthetic.render` without
    quads, spheres or lens distortion."""
    dev = textures.device
    h, w = cam["height"], cam["width"]
    T_wc = T_wc.to(dev)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    d_c = torch.stack([(xx - cam["cx"]) / cam["fx"], (yy - cam["cy"]) / cam["fy"], torch.ones_like(xx)], dim=-1)
    o = T_wc[:3, 3]
    d_w = torch.einsum("ij,hwj->hwi", T_wc[:3, :3], d_c)
    best_lam = torch.full((h, w), float("inf"), device=dev)
    best_val = torch.zeros((h, w), device=dev)
    for fid, (axis, sign) in enumerate(_FACES):
        ext = sign * _EXTENT[fid]
        denom = d_w[..., axis]
        lam = (ext - o[axis]) / torch.where(torch.abs(denom) > 1e-9, denom, torch.full_like(denom, 1e-9))
        hit = o + lam[..., None] * d_w
        ua, va = _UVAXES[fid]
        su, sv = _UVSPAN[fid]
        inside = (lam > 0.05) & (torch.abs(hit[..., ua]) <= su + 1e-4) & (torch.abs(hit[..., va]) <= sv + 1e-4)
        val = _bilinear(textures[fid], (hit[..., ua] + su) / (2 * su) * (TEX - 1),
                        (hit[..., va] + sv) / (2 * sv) * (TEX - 1))
        closer = inside & (lam < best_lam)
        best_lam = torch.where(closer, lam, best_lam)
        best_val = torch.where(closer, val, best_val)
    depth = torch.where(torch.isfinite(best_lam), best_lam, torch.zeros_like(best_lam))
    return best_val, depth


# ---- the sensor model and the looped sequences ----

def sensorize(gray: torch.Tensor, depth: torch.Tensor, gen: torch.Generator, sensor: dict):
    """(uint8 gray, int32 millimetre depth) of a stack (N, H, W) of renders:
    `endurance.sensorize` (rounded gray; depth + N(0, 1) * quad_sigma * z^2
    where z > 0, `n_holes` elliptical holes of radii in [hole_size // 3,
    hole_size) per frame; truncated to millimetres), drawn from `gen`."""
    n, h, w = depth.shape
    dev = depth.device
    g = torch.clamp(torch.round(gray), 0, 255).to(torch.uint8)
    noise = torch.randn(depth.shape, generator=gen, device=dev) * sensor["quad_sigma"] * depth * depth
    d = torch.where(depth > 0, torch.clamp(depth + noise, min=0.0), torch.zeros_like(depth))
    k, hs = sensor["n_holes"], sensor["hole_size"]
    cy = torch.randint(0, h, (n, k, 1, 1), generator=gen, device=dev).float()
    cx = torch.randint(0, w, (n, k, 1, 1), generator=gen, device=dev).float()
    ry = torch.randint(hs // 3, hs, (n, k, 1, 1), generator=gen, device=dev).float()
    rx = torch.randint(hs // 3, hs, (n, k, 1, 1), generator=gen, device=dev).float()
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    for i in range(n):  # one frame's k holes at a time bounds the mask's memory
        hole = (((yy - cy[i]) / ry[i]) ** 2 + ((xx - cx[i]) / rx[i]) ** 2 <= 1.0).any(dim=0)
        d[i] = torch.where(hole, torch.zeros_like(d[i]), d[i])
    mm = torch.clamp(d * sensor["depth_scale"], 0, 65535).to(torch.int32)
    return g, mm


@dataclass
class Traffic:
    """One rendered period and the frame order of each sequence."""

    name: str
    params: dict
    T_wc: np.ndarray  # (period, 4, 4) ground truth, camera to world
    gray: np.ndarray  # (period, H, W) uint8
    depth: np.ndarray  # (period, H, W) uint16 millimetres
    starts: List[int]  # first frame of each sequence
    fps: float

    @property
    def period(self) -> int:
        return self.T_wc.shape[0]

    def frame(self, seq: int, i: int) -> int:
        """Index into the period of sequence `seq`'s i-th frame."""
        return (self.starts[seq] + i) % self.period

    def timestamp(self, i: int) -> float:
        return i / self.fps


def load_params(bench_dir: Path, name: str) -> dict:
    return json.loads((bench_dir / "traffic" / f"{name}.json").read_text())


def seed_streams(seed: int) -> np.random.Generator:
    """The host-side draws of a run from `--seed`; any non-negative whole
    number, however large."""
    return np.random.default_rng(np.random.SeedSequence(int(seed)))


def build(name: str, params: dict, cam: dict, fps: float, n_seq: int, seed: int, device,
          n_render: int = 0) -> Traffic:
    """Render one period of the mix `params` for a run of `--seed` `seed`
    (only its first `n_render` frames where that is set: a warm-up's)."""
    rng = seed_streams(seed)
    room = params["room"]
    tex = torch.from_numpy(make_room_textures(room["texture_seed"], room["stripes"], room["low_texture"])).to(device)
    tr = params["trajectory"]
    n = n_render or tr["period_frames"]
    T_wc = orbit_trajectory(n, tr["radius"], tr["yaw_amp"], tuple(tr["center"]), tr["step_rad"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**63 - 1)))
    grays, depths = [], []
    chunk = 64
    for c0 in range(0, n, chunk):
        rend = [render(tex, cam, torch.from_numpy(T_wc[i])) for i in range(c0, min(n, c0 + chunk))]
        g, d = sensorize(torch.stack([r[0] for r in rend]), torch.stack([r[1] for r in rend]), gen,
                         params["sensor"])
        grays.append(g.cpu())
        depths.append(d.cpu())
    gray = torch.cat(grays).numpy()
    depth = torch.cat(depths).numpy().astype(np.uint16)
    stride = params["sequences"]["phase_stride_frames"]
    starts = [(tr["phase"] + s * stride) % n for s in range(n_seq)]
    return Traffic(name, params, T_wc, gray, depth, starts, fps)


def period_of(step_rad: float) -> float:
    """Frames after which sin(a), sin(2a) and sin(a / 2) all repeat."""
    return 4.0 * math.pi / step_rad
