"""Synthetic textured-room RGB-D renderer with exact ground truth.

Port of the room path of `hfvo_tpu.testing.synthetic`: a box room with
procedural textures (smooth noise + high-contrast blobs + dark stripes),
ray-cast per pixel under any camera pose. Textures come from the same
`np.random.RandomState` seeds, and their cubic upsampling is
`jax.image.resize`'s (`ops.image.resize`), so both packages render the same
scene. This is where the port's end-to-end runs get frames on a machine
without JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry import se3
from ..geometry.camera import Intrinsics
from ..ops.image import resize

# Room half-extents (meters): x in [-HX, HX], y in [-HY, HY], z in [-HZ, HZ].
HX, HY, HZ = 3.0, 2.0, 3.0
TEX = 512  # texture resolution per face

# Face table: (axis, sign). Plane equation: X[axis] = sign * extent.
_FACES = [(0, +1), (0, -1), (1, +1), (1, -1), (2, +1), (2, -1)]
_EXTENT = [HX, HX, HY, HY, HZ, HZ]
# In-plane texture axes for each face (the other two axes).
_UVAXES = [(1, 2), (1, 2), (0, 2), (0, 2), (0, 1), (0, 1)]
_UVSPAN = [(HY, HZ), (HY, HZ), (HX, HZ), (HX, HZ), (HX, HY), (HX, HY)]


def _cubic_up(coarse: np.ndarray) -> np.ndarray:
    return resize(torch.from_numpy(coarse), (TEX, TEX), "cubic").numpy().copy()


def make_room_textures(
    seed: int = 0, stripes: bool = True, low_texture: bool = False
) -> np.ndarray:
    """(6, TEX, TEX) float32 textures in [0, 255]. low_texture=True gives
    near-uniform walls with only the structural stripes."""
    rng = np.random.RandomState(seed)
    texs = []
    for _ in range(6):
        if low_texture:
            t = _cubic_up(rng.uniform(120, 150, size=(4, 4)).astype(np.float32))
        else:
            t = _cubic_up(
                rng.uniform(60, 200, size=(TEX // 32, TEX // 32)).astype(np.float32)
            )
            # High-contrast blobs: strong FAST corners everywhere.
            for _ in range(120):
                cy, cx = rng.randint(8, TEX - 8, size=2)
                s = rng.randint(3, 9)
                val = rng.choice([15.0, 240.0])
                t[cy : cy + s, cx : cx + s] = val
        if stripes:
            # Dark stripes parallel to texture axes -> straight 3D lines.
            for _ in range(6):
                pos = rng.randint(30, TEX - 30)
                wdt = rng.randint(4, 8)
                if rng.rand() < 0.5:
                    t[pos : pos + wdt, :] = 20.0
                else:
                    t[:, pos : pos + wdt] = 20.0
        texs.append(np.clip(t, 0, 255))
    return np.stack(texs).astype(np.float32)


class RoomScene(NamedTuple):
    textures: torch.Tensor  # (6, TEX, TEX)


def make_room(
    seed: int = 0, stripes: bool = True, low_texture: bool = False,
    device: torch.device | str = "cpu",
) -> RoomScene:
    return RoomScene(
        textures=torch.from_numpy(make_room_textures(seed, stripes, low_texture)).to(device)
    )


def render(
    scene: RoomScene, intr: Intrinsics, T_wc: torch.Tensor, distort: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render (gray (H, W), depth (H, W)) for camera-to-world pose T_wc, on
    the device of the scene's textures. With `distort`, each pixel's ray
    comes from undistorting its coordinates through the intrinsics' radtan
    model."""
    dev = scene.textures.device
    h, w = intr.height, intr.width
    T_wc = T_wc.to(dev)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    if distort and intr.has_distortion:
        from ..geometry import camera as camera_mod

        uv = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1)
        und = camera_mod.undistort_points(intr, uv)
        xn = ((und[:, 0] - intr.cx) / intr.fx).reshape(h, w)
        yn = ((und[:, 1] - intr.cy) / intr.fy).reshape(h, w)
    else:
        xn = (xx - intr.cx) / intr.fx
        yn = (yy - intr.cy) / intr.fy
    d_c = torch.stack([xn, yn, torch.ones_like(xx)], dim=-1)  # z-normalized rays
    R = T_wc[:3, :3]
    o = T_wc[:3, 3]
    d_w = torch.einsum("ij,hwj->hwi", R, d_c)

    best_lam = torch.full((h, w), float("inf"), device=dev)
    best_val = torch.zeros((h, w), device=dev)
    for fid, (axis, sign) in enumerate(_FACES):
        ext = sign * _EXTENT[fid]
        denom = d_w[..., axis]
        lam = (ext - o[axis]) / torch.where(
            torch.abs(denom) > 1e-9, denom, torch.full_like(denom, 1e-9)
        )
        hit = o + lam[..., None] * d_w
        ua, va = _UVAXES[fid]
        su, sv = _UVSPAN[fid]
        inside = (
            (lam > 0.05)
            & (torch.abs(hit[..., ua]) <= su + 1e-4)
            & (torch.abs(hit[..., va]) <= sv + 1e-4)
        )
        tu = (hit[..., ua] + su) / (2 * su) * (TEX - 1)
        tv = (hit[..., va] + sv) / (2 * sv) * (TEX - 1)
        tex = scene.textures[fid]
        x0 = torch.clamp(torch.floor(tu).long(), 0, TEX - 2)
        y0 = torch.clamp(torch.floor(tv).long(), 0, TEX - 2)
        fx = torch.clamp(tu - x0, 0.0, 1.0)
        fy = torch.clamp(tv - y0, 0.0, 1.0)
        val = (
            tex[y0, x0] * (1 - fx) * (1 - fy)
            + tex[y0, x0 + 1] * fx * (1 - fy)
            + tex[y0 + 1, x0] * (1 - fx) * fy
            + tex[y0 + 1, x0 + 1] * fx * fy
        )
        closer = inside & (lam < best_lam)
        best_lam = torch.where(closer, lam, best_lam)
        best_val = torch.where(closer, val, best_val)
    depth = torch.where(torch.isfinite(best_lam), best_lam, torch.zeros_like(best_lam))
    return best_val, depth


def corrupt_depth(
    depth: np.ndarray,
    rng: np.random.Generator,
    quad_sigma: float = 0.01,
    n_holes: int = 12,
    hole_size: int = 28,
) -> np.ndarray:
    """Kinect-style depth corruption (numpy, copied from
    hfvo_tpu/testing/synthetic.py:169, so the same generator gives the same
    bits): quadratic-in-z noise (sigma = quad_sigma * z^2, the standard
    structured-light error model) plus elliptical dropout holes (occlusion
    shadows / absorbing surfaces)."""
    d = np.asarray(depth).copy()
    h, w = d.shape
    z = d
    noise = rng.standard_normal(d.shape).astype(np.float32) * quad_sigma * z * z
    d = np.where(z > 0, np.maximum(z + noise, 0.0), 0.0)
    for _ in range(n_holes):
        cy = rng.integers(0, h)
        cx = rng.integers(0, w)
        ry = rng.integers(hole_size // 3, hole_size)
        rx = rng.integers(hole_size // 3, hole_size)
        yy, xx = np.ogrid[:h, :w]
        mask = ((yy - cy) / max(ry, 1)) ** 2 + ((xx - cx) / max(rx, 1)) ** 2 <= 1.0
        d[mask] = 0.0
    return d.astype(np.float32)


def orbit_trajectory(
    n: int,
    radius: float = 0.6,
    yaw_amp: float = 0.35,
    center: Tuple[float, float, float] = (0.0, 0.0, -0.8),
    step: float = 0.3 * np.pi / 24.0,
) -> np.ndarray:
    """Smooth camera path inside the room -> (n, 4, 4) T_wc (camera to
    world): a horizontal arc with yaw, looking roughly at the +z wall, at
    the 1-3 cm / <1 deg per-frame scale of a 30 fps handheld sequence."""
    out = []
    for i in range(n):
        ang = step * i
        t = np.array(
            [
                center[0] + radius * np.sin(ang),
                center[1] + 0.15 * np.sin(2 * ang),
                center[2] + 0.3 * np.sin(ang * 0.5),
            ],
            np.float32,
        )
        yaw = yaw_amp * np.sin(ang)
        pitch = 0.08 * np.sin(2 * ang)
        Rz = se3.exp_so3(torch.tensor([0.0, yaw, 0.0], dtype=torch.float32)).numpy()
        Rx = se3.exp_so3(torch.tensor([pitch, 0.0, 0.0], dtype=torch.float32)).numpy()
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rz @ Rx
        T[:3, 3] = t
        out.append(T)
    return np.stack(out)


def render_sequence(
    n: int = 30,
    intr: Optional[Intrinsics] = None,
    seed: int = 0,
    stripes: bool = True,
    scene: Optional[RoomScene] = None,
    distort: bool = False,
    device: torch.device | str = "cpu",
):
    """Convenience: (T_wc (n,4,4), grays list, depths list) of numpy arrays
    on the default orbit, rendered on `device`."""
    from ..config import tum3_config

    intr = intr or tum3_config().camera
    scene = scene if scene is not None else make_room(seed, stripes, device=device)
    T_wc = orbit_trajectory(n)
    grays, depths = [], []
    for i in range(n):
        g, d = render(scene, intr, torch.from_numpy(T_wc[i]), distort)
        grays.append(g.cpu().numpy())
        depths.append(d.cpu().numpy())
    return T_wc, grays, depths


def write_tum_sequence(d: str, grays, depths, settings: str, rgb: bool = True) -> None:
    """Write frames as a TUM directory (tests/test_cli_e2e.py's layout):
    rgb/<t>.png (the uint8 gray as RGB, or as 8-bit gray with `rgb=False`),
    depth/<t>.png (16-bit, metres x 5000, TUM's DepthMapFactor), assoc.txt
    and settings.yaml holding `settings`; frame i has timestamp i / 30."""
    import os

    from PIL import Image

    os.makedirs(os.path.join(d, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(d, "depth"), exist_ok=True)
    lines = []
    for i, (g, dep) in enumerate(zip(grays, depths)):
        ts = i / 30.0
        g8 = np.clip(np.asarray(g), 0, 255).astype(np.uint8)
        Image.fromarray(np.stack([g8, g8, g8], axis=-1) if rgb else g8).save(
            os.path.join(d, "rgb", f"{ts:.6f}.png"))
        d16 = np.clip(np.asarray(dep) * 5000.0, 0, 65535).astype(np.uint16)
        Image.fromarray(d16).save(os.path.join(d, "depth", f"{ts:.6f}.png"))
        lines.append(f"{ts:.6f} rgb/{ts:.6f}.png {ts:.6f} depth/{ts:.6f}.png")
    with open(os.path.join(d, "assoc.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(d, "settings.yaml"), "w") as f:
        f.write(settings)
