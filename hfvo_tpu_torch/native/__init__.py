"""ctypes bindings for the native C++ sequence loader.

Port of `hfvo_tpu.native`: `loader.cpp` (a copy of the JAX package's
source: libpng decode on a pthread worker pool with a prefetch ring) is
built with g++ at first use, never at import, into
`build/hfvo_tpu_torch/` at the repository root (the library name carries a
hash of the source and flags, so an edited source is rebuilt), and exposes
`NativeSequenceLoader`. This is the host's file decoding: the CLI's
`--loader auto` takes `io.tum.iterate_sequence` when the library cannot
build (no g++ or no libpng headers), and `--loader native` then exits with
`build_error()`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "loader.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hfvo_tpu_torch"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-lpng", "-lz", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS + _LIBS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"libhfvo_loader_{digest}.so"


def _build() -> Optional[str]:
    """Compile the loader unless its library is up to date. Returns an
    error string or None."""
    target = library_path()
    if target.exists():
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp), *_LIBS]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:  # toolchain missing or stuck
        return str(e)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return r.stderr[-2000:]
    os.replace(tmp, target)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None:
        return _lib
    _build_error = _build()
    if _build_error:
        return None
    try:
        lib = ctypes.CDLL(str(library_path()))
    except OSError as e:  # built elsewhere, and libpng is missing here
        _build_error = str(e)
        return None
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_frame_count.restype = ctypes.c_int
    lib.loader_frame_count.argtypes = [ctypes.c_void_p]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


class NativeSequenceLoader:
    """Prefetching RGB-D sequence iterator backed by the C++ worker pool:
    yields (timestamp, gray float32 [0, 255], depth float32 metres)."""

    def __init__(
        self,
        seq_dir: str,
        assoc_path: str,
        depth_factor: float = 5000.0,
        n_workers: int = 3,
        queue_cap: int = 8,
        max_hw: Tuple[int, int] = (480, 640),
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.loader_create(
            seq_dir.encode(), assoc_path.encode(),
            ctypes.c_double(depth_factor), n_workers, queue_cap,
        )
        if not self._h:
            raise RuntimeError(f"failed to open association file {assoc_path}")
        self._hw = max_hw

    def __len__(self) -> int:
        return self._lib.loader_frame_count(self._h)

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
        H, W = self._hw
        gray = np.empty((H, W), np.float32)
        depth = np.empty((H, W), np.float32)
        ts = ctypes.c_double()
        w = ctypes.c_int()
        h = ctypes.c_int()
        while True:
            r = self._lib.loader_next(
                self._h,
                gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.byref(ts), ctypes.byref(w), ctypes.byref(h),
            )
            if r == 0:
                return
            if r < 0:
                continue  # undecodable frame: skip (reference aborts instead)
            hh, ww = h.value, w.value
            yield ts.value, gray[:hh, :ww].copy(), depth[:hh, :ww].copy()

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.loader_destroy(self._h)
            self._h = None

    def __enter__(self) -> "NativeSequenceLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
