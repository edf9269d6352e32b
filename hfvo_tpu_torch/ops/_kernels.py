"""Build and load the port's hand-written CUDA kernels.

Each source `hfvo_tpu_torch/csrc/<name>.cu` has a plain C interface and is
compiled by `nvcc` for `sm_90a` into its own shared library, loaded with
ctypes. Nothing includes PyTorch's headers. The build runs at first use, never
at import, into `build/hfvo_tpu_torch/` at the repository root; the library
name carries a hash of the source and flags, so an edited source is rebuilt.
Every source also exports `const char *hfvo_cuda_error_string(int)`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "hfvo_tpu_torch"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, in the build output
)

_loaded: Dict[str, ctypes.CDLL] = {}


def names() -> list:
    """Every kernel source of the package, by name."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> str:
    """Compile kernel `name` unless its library is up to date. Returns the
    compiler's output (as `build_all`); raises if nvcc fails."""
    return build_all([name])[name]


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Compile every kernel of `names` that is not up to date, one nvcc
    process per source, all started together. Returns {name: compiler
    output}, the output of the build that made the library where it was up
    to date ("up to date" if none was kept); raises if any build fails
    (after all have ended)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for name in names:
        target = library_path(name)
        if target.exists():
            log = target.with_suffix(".log")
            out[name] = log.read_text() if log.exists() else "up to date"
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out[name] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out[name]}")
        else:
            target.with_suffix(".log").write_text(out[name])
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use, with
    `signatures` ({symbol: (restype, argtypes)}) applied."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build(name)
    lib = _loaded[name] = open_library(library_path(name), signatures)
    return lib


def open_library(path: Path, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The shared library at `path`, built from a kernel source, with
    `signatures` and `hfvo_cuda_error_string`'s applied."""
    lib = ctypes.CDLL(str(path))
    lib.hfvo_cuda_error_string.restype = ctypes.c_char_p
    lib.hfvo_cuda_error_string.argtypes = [ctypes.c_int]
    for sym, (restype, argtypes) in signatures.items():
        fn = getattr(lib, sym)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"{err} ({lib.hfvo_cuda_error_string(err).decode()})"


def spill_bytes(log: str) -> int:
    """Bytes of spill stores and loads, summed over the functions, that
    ptxas reports in a build's output (`-Xptxas=-v`)."""
    found = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    return sum(int(a) + int(b) for a, b in found)
