"""Per-frame feature container + extraction orchestration.

Port of `hfvo_tpu.tracking.frontend` (reference: `Frame::Frame` RGB-D,
src/Frame.cc:150, and `ComputeStereoFromRGBD`, src/Frame.cc:1940).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import VOConfig
from ..geometry import camera
from ..ops import orb
from ..ops.batch import gather_pixels


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame features; batched over sequences, every
    leaf has a leading (S,) axis."""

    uv: torch.Tensor  # (N, 2) float32 undistorted pixel coords
    obs: torch.Tensor  # (N, 3) float32 (u, v, u_r); u_r valid iff has depth
    desc: torch.Tensor  # (N, 8) int64 words
    angle: torch.Tensor  # (N,)
    octave: torch.Tensor  # (N,) int64
    response: torch.Tensor  # (N,)
    depth: torch.Tensor  # (N,) float32 (<= 0 means no depth)
    valid: torch.Tensor  # (N,) bool
    inv_sigma2: torch.Tensor  # (N,) information scale 1/1.2^(2*octave)


def _sample_depth(depth_img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Depth at (rounded, half to even) keypoint locations, clamped into the
    image: depth_img (*B, H, W), uv (*B, N, 2)."""
    h, w = depth_img.shape[-2:]
    x = torch.clamp(torch.round(uv[..., 0]).long(), 0, w - 1)
    y = torch.clamp(torch.round(uv[..., 1]).long(), 0, h - 1)
    return gather_pixels(depth_img, y, x)


def extract_frame(
    gray: torch.Tensor, depth_img: torch.Tensor, cfg: VOConfig
) -> FrameFeatures:
    """ORB + depth association for one RGB-D frame, or for S frames stacked
    as (S, H, W): u_r = u - bf/d."""
    feats = orb.extract_orb(gray, cfg.orb, cfg.cap.keypoints)
    uv = feats.uv
    if cfg.camera.has_distortion:
        uv = camera.undistort_points(cfg.camera, uv)
    d = _sample_depth(depth_img, feats.uv)  # sample at raw (distorted) coords
    has_d = d > 1e-3
    ur = torch.where(
        has_d, uv[..., 0] - cfg.camera.bf / torch.where(has_d, d, torch.ones_like(d)),
        torch.full_like(d, -1.0),
    )
    obs = torch.cat([uv, ur[..., None]], dim=-1)
    inv_sigma2 = 1.0 / torch.pow(
        torch.tensor(cfg.orb.scale_factor, dtype=torch.float32, device=uv.device),
        2.0 * feats.octave.float(),
    )
    return FrameFeatures(
        uv=uv,
        obs=obs,
        desc=feats.desc,
        angle=feats.angle,
        octave=feats.octave,
        response=feats.response,
        depth=torch.where(has_d, d, torch.zeros_like(d)),
        valid=feats.valid,
        inv_sigma2=inv_sigma2,
    )
