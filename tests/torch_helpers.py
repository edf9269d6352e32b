"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Inputs are numpy arrays made from a seed; each test hands the same arrays to
the JAX function (`hfvo_tpu`, on the CPU) and to its PyTorch port
(`hfvo_tpu_torch`) and compares the outputs as numpy.
"""
import fcntl
import functools
import itertools
import os
import pickle

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


def _shared_root(tmp_path_factory):
    """The run's base temp, which every xdist worker of the run shares."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER") is not None:
        root = root.parent
    return root


def pytest_collection_finish(session):
    """Turn on JAX's persistent compilation cache for this pytest process
    once it has collected its tests, in the run's shared base temp: a JAX
    program that one xdist worker has compiled is then loaded by the others
    instead of compiled again. The port's tests and the JAX package's
    compile many of the same programs (a JAX tracker's step compiles for
    30-70 s on the CPU), in several workers each. It is on for every test
    of the process, the JAX package's too: it changes how a program is
    obtained, not the program. A pytest hook: `tests/test_torch_ba.py`
    registers this module as a plugin (`pytest_plugins`), and every worker
    collects it.

    JAX writes only programs that took at least
    `jax_persistent_cache_min_compile_time_secs` (1 s) to compile; a size
    limit turns on JAX's file lock, so that no worker reads an entry another
    one is still writing. XLA's CPU loader logs a feature mismatch
    (`+prefer-no-gather`, a tuning flag) on each load; the machine is the
    same. XLA has been seen to abort a worker inside an executable's
    `serialize` for the cache (once in a run of the whole suite);
    `tests/conftest.py` runs the test again on a new worker."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    # The factory behind the `tmp_path_factory` fixture (no fixture here).
    compilation_cache.set_cache_dir(str(_shared_root(session.config._tmp_path_factory) / "jax_cache"))
    jax.config.update("jax_compilation_cache_max_size", 1 << 30)
    # JAX opens the cache at a process's first compile; open it anew here.
    compilation_cache.reset_cache()


_BUSY = object()


def _shared_one(root, name: str, compute, wait: bool):
    """`name`'s result from the run's base temp, computed and pickled there
    under its file lock by the first to take the lock; _BUSY where another
    worker holds the lock and `wait` is false."""
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | (0 if wait else fcntl.LOCK_NB))
        except BlockingIOError:
            return _BUSY
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        out = compute()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, path)
        return out


def shared_results(tmp_path_factory, computes: dict) -> dict:
    """{name: computes[name]()}, each computed once for this pytest run, all
    xdist workers included (see `shared_result`). A worker first computes,
    in the order given (costliest first), every result that no worker has
    taken yet, and only then waits for those another worker is computing:
    two workers that reach a module's fixtures together compute two of them
    at once, instead of one computing while the other waits."""
    root = _shared_root(tmp_path_factory)
    out = {}
    for wait in (False, True):
        for name, compute in computes.items():
            if name not in out:
                got = _shared_one(root, name, compute, wait)
                if got is not _BUSY:
                    out[name] = got
    return out


def shared_result(tmp_path_factory, name: str, compute):
    """`compute()` once for this pytest run, all xdist workers included: the
    first to get here computes it under a file lock in the run's base temp
    (the one the workers share) and pickles the result; the others wait on
    the lock and load it. For costly module fixtures, which `--dist load`
    would otherwise set up once in each worker that picks up one of their
    tests, and fixtures two modules share. The result must be picklable
    (numpy, not a live tracker)."""
    return _shared_one(_shared_root(tmp_path_factory), name, compute, wait=True)
