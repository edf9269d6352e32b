"""TUM/ICL-NUIM RGB-D dataset loading.

Port of `hfvo_tpu.io.tum` (numpy + PIL, copied; PIL decodes as in the JAX
package: `convert("L")` for gray, 16-bit depth divided by
`DepthMapFactor`), plus `read_mask`, the static-mask loader of the JAX
package's tracker (hfvo_tpu/tracking/tracker.py:708-720).

Replicates the reference driver's association-file loader
(reference: Examples/RGB-D/rgbd_tum.cc:182-207 `LoadImages`): each line is
`t_rgb rgb/<f>.png t_depth depth/<f>.png`. Depth PNGs are uint16 scaled by
`DepthMapFactor` (5000 for TUM). PNG decoding goes through PIL on the host;
the compute path never touches image files.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np


@dataclass
class Association:
    timestamps: List[float]
    rgb_paths: List[str]
    depth_paths: List[str]

    def __len__(self) -> int:
        return len(self.timestamps)


def load_association(path: str) -> Association:
    """Parse a TUM association file (t1 rgb t2 depth per line)."""
    ts, rgbs, depths = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            try:
                t = float(parts[0])
            except ValueError:
                continue  # tolerate stray non-numeric lines
            ts.append(t)
            rgbs.append(parts[1])
            depths.append(parts[3])
    return Association(ts, rgbs, depths)


def associate(rgb_txt: str, depth_txt: str, max_dt: float = 0.02) -> Association:
    """Build an association from raw rgb.txt/depth.txt listings (nearest
    timestamp within max_dt), for sequences shipped without association files."""

    def _parse(path):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, p = line.split()[:2]
                out.append((float(t), p))
        return out

    rgb = _parse(rgb_txt)
    depth = _parse(depth_txt)
    d_ts = np.array([t for t, _ in depth])
    ts, rgbs, depths = [], [], []
    for t, p in rgb:
        j = int(np.argmin(np.abs(d_ts - t)))
        if abs(d_ts[j] - t) <= max_dt:
            ts.append(t)
            rgbs.append(p)
            depths.append(depth[j][1])
    return Association(ts, rgbs, depths)


def load_frame(
    seq_dir: str, rgb_rel: str, depth_rel: str, depth_factor: float = 5000.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Load one RGB-D pair -> (gray float32 [0,255] HxW, depth float32 meters HxW)."""
    from PIL import Image

    rgb = Image.open(os.path.join(seq_dir, rgb_rel))
    gray = np.asarray(rgb.convert("L"), dtype=np.float32)
    d = np.asarray(Image.open(os.path.join(seq_dir, depth_rel)))
    depth = d.astype(np.float32) / depth_factor
    return gray, depth


def iterate_sequence(
    seq_dir: str, association_file: str, depth_factor: float = 5000.0
) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
    """Yield (timestamp, gray, depth_m) for every associated frame."""
    assoc = load_association(association_file)
    for t, r, d in zip(assoc.timestamps, assoc.rgb_paths, assoc.depth_paths):
        gray, depth = load_frame(seq_dir, r, d, depth_factor)
        yield t, gray, depth


def read_mask(path: str, height: int, width: int) -> np.ndarray:
    """A static feature mask image as (height, width) bool, True = usable
    (nonzero). A mask of another shape is resized with PIL's NEAREST rule,
    as the JAX package's tracker loads it."""
    from PIL import Image

    m = np.asarray(Image.open(path).convert("L"))
    if m.shape != (height, width):
        m = np.asarray(Image.fromarray(m).resize((width, height), Image.NEAREST))
    return m > 0
