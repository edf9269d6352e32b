"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Inputs are numpy arrays made from a seed; each test hands the same arrays to
the JAX function (`hfvo_tpu`, on the CPU) and to its PyTorch port
(`hfvo_tpu_torch`) and compares the outputs as numpy.
"""
import functools
import itertools

import numpy as np
import pytest
import torch

from hfvo_tpu_torch.config import tum3_config
from hfvo_tpu_torch.geometry.camera import Intrinsics

SMALL_H, SMALL_W = 120, 160

# One intra-op thread: the port's tests run small eager ops next to XLA's
# own CPU thread pools in several xdist workers, where torch's OpenMP
# threads only contend (a 25-frame render took 10x longer with them).
torch.set_num_threads(1)


def small_intrinsics() -> Intrinsics:
    """tum3's camera scaled to 160x120."""
    c = tum3_config().camera
    s = SMALL_W / c.width
    return c._replace(fx=c.fx * s, fy=c.fy * s, cx=c.cx * s, cy=c.cy * s,
                      bf=c.bf * s, width=SMALL_W, height=SMALL_H)


def half_camera() -> Intrinsics:
    """tum3's camera at 320x240, for the cases that track whole frames but
    whose bookkeeping does not depend on the image size."""
    c = tum3_config().camera
    return c._replace(fx=c.fx / 2, fy=c.fy / 2, cx=c.cx / 2, cy=c.cy / 2, bf=c.bf / 2,
                      width=c.width // 2, height=c.height // 2)


@functools.lru_cache(maxsize=None)
def small_frame():
    """(gray, depth) float32 numpy, 120x160, frame 3 of the default orbit
    rendered by the port's renderer (cached; callers must not mutate)."""
    from hfvo_tpu_torch.testing import synthetic

    T_wc = synthetic.orbit_trajectory(4)[3]
    g, d = synthetic.render(
        synthetic.make_room(0), small_intrinsics(), torch.from_numpy(T_wc)
    )
    return g.numpy(), d.numpy()


@functools.lru_cache(maxsize=None)
def small_frames(indices=(3,)):
    """((gray, depth), ...) float32 numpy, 120x160, the given frames of the
    default orbit's first 4 (cached; callers must not mutate)."""
    from hfvo_tpu_torch.testing import synthetic

    room = synthetic.make_room(0)
    T_wc = synthetic.orbit_trajectory(4)
    out = []
    for i in indices:
        g, d = synthetic.render(room, small_intrinsics(), torch.from_numpy(T_wc[i]))
        out.append((g.numpy(), d.numpy()))
    return tuple(out)


def noise_image(h: int = 250, w: int = 330, seed: int = 7) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)


def t(a) -> torch.Tensor:
    """numpy -> CPU tensor (a copy, so the port cannot alias test inputs)."""
    return torch.from_numpy(np.array(a))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none. Decided
    when the test runs, so every xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda", 0)


# The 24 proper signed permutations of the three axes.
AXIS_PERMS = [
    P for P in (
        np.diag(s)[list(p)] for p in itertools.permutations(range(3))
        for s in itertools.product((1.0, -1.0), repeat=3)
    ) if np.linalg.det(P) > 0
]


def same_frame(Ra, Rb, tol) -> bool:
    """Ra and Rb (columns = axes) are the same Manhattan frame up to a
    proper signed permutation of the axes, within `tol` per entry."""
    return min(np.abs(np.asarray(Ra) - np.asarray(Rb) @ P).max() for P in AXIS_PERMS) < tol
