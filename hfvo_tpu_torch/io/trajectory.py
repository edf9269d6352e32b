"""TUM-format trajectory read/write.

Mirrors the reference's `SaveTrajectoryTUM` output contract
(reference: src/System.cc:346-404): one line per frame,
`timestamp tx ty tz qx qy qz qw` of the camera-to-world pose `T_wc`.
The reference stores per-frame poses relative to a reference keyframe and
chains through optimized keyframe poses at save time; the equivalent chaining
lives in `hfvo_tpu_torch.system` — this module is pure formatting.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.spatial.transform import Rotation


def save_tum(
    path: str, timestamps: Sequence[float], T_wc: np.ndarray
) -> None:
    """Write poses (N, 4, 4) camera-to-world as a TUM trajectory file."""
    T_wc = np.asarray(T_wc, dtype=np.float64)
    q = Rotation.from_matrix(T_wc[:, :3, :3]).as_quat()  # (x, y, z, w)
    t = T_wc[:, :3, 3]
    with open(path, "w") as f:
        for i, ts in enumerate(timestamps):
            f.write(
                f"{ts:.6f} {t[i,0]:.7f} {t[i,1]:.7f} {t[i,2]:.7f} "
                f"{q[i,0]:.7f} {q[i,1]:.7f} {q[i,2]:.7f} {q[i,3]:.7f}\n"
            )


def load_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a TUM trajectory file -> (timestamps (N,), T_wc (N, 4, 4))."""
    ts: List[float] = []
    poses: List[np.ndarray] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            if len(vals) < 8:
                continue
            ts.append(vals[0])
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = Rotation.from_quat(vals[4:8]).as_matrix()
            T[:3, 3] = vals[1:4]
            poses.append(T)
    return np.array(ts), np.stack(poses) if poses else np.zeros((0, 4, 4), np.float32)
