#!/usr/bin/env python3
"""Ablation of the Hough-vote kernels' design (`hfvo_tpu_torch/csrc/hough_vote.cu`) on the GPU.

    python3 hough_ablation.py [--out FILE]

Builds the source as it is and variants of it (one nvcc per variant, all
started together, into `build/hough_ablation/`), holds every variant to the
plain PyTorch version with `chip_smoke.py`'s gates (relative error within
K3_RTOL, the same top-4 bins wherever they are decided) on a rendered
480x640 frame, 250x330 noise, a stack of 8 frames and a stack of 8 noise
images, then times each on
the card in two interleaved rounds (CUDA events behind a GPU sleep, as
`chip_smoke.py` times):

- K3: one launch on the 70 tiles of one frame (frame 1 of the orbit of
  seed 0);
- K3b: one launch on the 560 tiles of the stack of 8 (frame 1 of the orbits
  of seeds 0-7, as `chip_smoke.py` stacks them), with its GB/s (8 B a
  tiled pixel and the accumulators).

Every variant is also timed on the stack with no pixel voting (mag_th = inf: the
loads, the cluster's barriers, the sums and the write; what the votes add
is the difference) and on a stack of 8 480x640 uniform-noise images
(98 % of the pixels vote, every list full).

Variants, each undoing one step of the design: `one_block_per_tile` (the
kernel before it: one 1,024-thread block a tile, votes in place, IEEE
divisions in the bins; kept here as the same-call baseline);
`ieee_div_bins` (the bins by `__fdiv_rn`, the row wrap by `%`);
`votes_in_place` (each thread votes its own pixels, no list);
`one_atomic_a_vote` (the list, without the run sums); `cluster_1`,
`cluster_2`, `cluster_4`, `cluster_8` (that many blocks of 256 threads a
tile; the one the source sets is the source unchanged). Prints ptxas's
registers and spills, the shared-memory atomics of the SASS and each
launch's shape, then the card's name and power limit, then one JSON line. Needs one CUDA device and nvcc; imports no
JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "hfvo_tpu_torch" / "csrc" / "hough_vote.cu"
OUT_DIR = ROOT / "build" / "hough_ablation"

# The kernel of csrc/hough_vote.cu before the cluster design, as it was
# measured at 17.4 us a frame: one 1,024-thread block a tile, bins by
# correctly rounded division. It reads the first 72 floats of the same table.
ONE_BLOCK_PER_TILE = r'''
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;
constexpr int N_THETA = 36;
constexpr int N_RHO = 48;
constexpr int THREADS = 1024;
constexpr int PX_PER_THREAD = TILE * TILE / THREADS;  // 4
constexpr float PI_F = 3.14159265358979323846f;
constexpr float DIAG_F = 90.50966799187808f;  // 64 * sqrt(2), rounded to float32

__global__ void __launch_bounds__(THREADS)
hough_vote_kernel(const float* __restrict__ mag, const float* __restrict__ ang,
                  const float* __restrict__ table, float* __restrict__ out,
                  int h, int w, float mag_th) {
  __shared__ float acc[N_THETA * N_RHO];
  __shared__ float cos_t[N_THETA];
  __shared__ float sin_t[N_THETA];
  const int tid = threadIdx.x;
  for (int i = tid; i < N_THETA * N_RHO; i += THREADS) acc[i] = 0.0f;
  if (tid < N_THETA) {
    cos_t[tid] = table[tid];
    sin_t[tid] = table[N_THETA + tid];
  }
  __syncthreads();

  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  mag += plane;
  ang += plane;
  const int x0 = blockIdx.x * TILE;
  const int y0 = blockIdx.y * TILE;
  float mv[PX_PER_THREAD], av[PX_PER_THREAD];
#pragma unroll
  for (int i = 0; i < PX_PER_THREAD; ++i) {
    const int p = tid + i * THREADS;
    const int g = (y0 + p / TILE) * w + (x0 + p % TILE);
    mv[i] = mag[g];
    av[i] = ang[g];
  }
#pragma unroll
  for (int i = 0; i < PX_PER_THREAD; ++i) {
    const int p = tid + i * THREADS;
    const int yl = p / TILE, xl = p % TILE;
    const float m = mv[i];
    if (!(m > mag_th)) continue;
    const float a = av[i];
    int tb = static_cast<int>(__fmul_rn(__fdiv_rn(a, PI_F), static_cast<float>(N_THETA)));
    tb = min(max(tb, 0), N_THETA - 1);
    const float fx = static_cast<float>(xl), fy = static_cast<float>(yl);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int delta = k == 0 ? 0 : (k == 1 ? -1 : 1);
      const int t = (tb + delta + N_THETA) % N_THETA;
      const float rho = __fadd_rn(__fmul_rn(fx, cos_t[t]), __fmul_rn(fy, sin_t[t]));
      const float r = __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(rho, DIAG_F), 1.0f), 0.5f),
                                static_cast<float>(N_RHO));
      int rb = static_cast<int>(r);
      rb = min(max(rb, 0), N_RHO - 1);
      atomicAdd(&acc[t * N_RHO + rb], k == 0 ? m : __fmul_rn(m, 0.5f));
    }
  }
  __syncthreads();

  const int64_t tile = (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  float* dst = out + tile * (N_THETA * N_RHO);
  for (int i = tid; i < N_THETA * N_RHO; i += THREADS) dst[i] = acc[i];
}

}  // namespace

extern "C" {

int hfvo_hough_vote(const float* mag, const float* ang, const float* table, float* out,
                    int s, int h, int w, float mag_th, void* stream) {
  const dim3 grid(w / TILE, h / TILE, s);
  hough_vote_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      mag, ang, table, out, h, w, mag_th);
  return static_cast<int>(cudaGetLastError());
}

const char* hfvo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
'''

# The bins by correctly rounded division, as ONE_BLOCK_PER_TILE computes
# them, in place of the source's guess-and-correct theta bin and scaled rho
# bin; the row wrap by `%`.
_DIV_THETA = '''  int tb = static_cast<int>(__fmul_rn(__fdiv_rn(a, 3.14159265358979323846f), 36.0f));
  return min(max(tb, 0), N_THETA - 1);
}'''
_DIV_RHO = '''  const float r = __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(rho, 90.50966799187808f), 1.0f), 0.5f), 48.0f);
  return min(max(static_cast<int>(r), 0), N_RHO - 1);
}'''
_DIV_WRAP = "      const int t = (tb + (k == 0 ? 0 : (k == 1 ? -1 : 1)) + N_THETA) % N_THETA;"


def _body(src: str, signature: str, body: str) -> str:
    """`src` with the body of the function that starts at `signature`
    replaced by `body` (which ends with the closing brace)."""
    i0 = src.index(signature) + len(signature)
    i1 = src.index("\n}", i0) + 2
    return src[:i0] + "\n" + body + src[i1:]


def _ieee_div(src: str) -> str:
    src = _body(src, "__device__ __forceinline__ int theta_bin(float a, const float2* edge) {", _DIV_THETA)
    src = _body(src, "__device__ __forceinline__ int rho_bin(float rho) {", _DIV_RHO)
    i0 = src.index("      const int t = k == 0 ? tb")
    i1 = src.index(";", i0) + 1
    return src[:i0] + _DIV_WRAP + src[i1:]


# Each thread votes its own pixels where it loaded them, in place of the
# list of voting pixels and its spread over the lanes.
_IN_PLACE = r"""#pragma unroll
  for (int i = 0; i < PX_PER_THREAD; ++i) {
    const float m = mv[i];
    if (!(m > mag_th)) continue;
    const float fx = static_cast<float>(col);
    const float fy = static_cast<float>(row0 + i * (THREADS / TILE));
    const int tb = theta_bin(av[i], edge);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int t = k == 0 ? tb : (k == 1 ? (tb == 0 ? N_THETA - 1 : tb - 1)
                                          : (tb == N_THETA - 1 ? 0 : tb + 1));
      const float2 c = cs[t];
      const float rho = __fadd_rn(__fmul_rn(fx, c.x), __fmul_rn(fy, c.y));
      atomicAdd(&acc[t * N_RHO + rho_bin(rho)], k == 0 ? m : __fmul_rn(m, 0.5f));
    }
  }

"""


def _in_place(src: str) -> str:
    i0 = src.index("  // Each warp lists its voting pixels")
    i1 = src.index("  // Block `rank` sums its share")
    return src[:i0] + _IN_PLACE + src[i1:]


def _one_atomic_a_vote(src: str) -> str:
    """Each vote of the list its own atomic, in place of the run sums."""
    i0 = src.index("      const int prev = __shfl_up_sync(FULL_WARP, bin[k], 1);")
    i1 = src.index("      tail[k] = on && (lane == 31", i0)
    i1 = src.index("\n", i1) + 1
    return src[:i0] + "      tail[k] = on;\n" + src[i1:]


def _cluster(c: int):
    def make(src: str) -> str:
        out, n = re.subn(r"constexpr int CLUSTER = \d+;", f"constexpr int CLUSTER = {c};", src)
        if n != 1:
            raise RuntimeError("hough_ablation: the source no longer sets CLUSTER once")
        return out

    return make


VARIANTS = {
    "one_block_per_tile": lambda s: ONE_BLOCK_PER_TILE,
    "ieee_div_bins": _ieee_div,
    "votes_in_place": _in_place,
    "one_atomic_a_vote": _one_atomic_a_vote,
    "cluster_1": _cluster(1),
    "cluster_2": _cluster(2),
    "cluster_4": _cluster(4),
    "cluster_8": _cluster(8),
}


def build():
    """{variant: (ctypes library, ptxas register/spill lines, spill bytes,
    whether it is the source unchanged)}; raises if a build fails."""
    from hfvo_tpu_torch.ops import _kernels, lines

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src, procs = SOURCE.read_text(), {}
    for name, make in VARIANTS.items():
        cu = OUT_DIR / f"{name}.cu"
        text = make(src)
        cu.write_text(text)
        cmd = [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(OUT_DIR / f"lib{name}.so"), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       text == src)
    libs = {}
    sig = {"hfvo_hough_vote": lines._HOUGH_SIGNATURES["hfvo_hough_vote"]}
    for name, (proc, is_source) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"hough_ablation: {name} failed to build\n{log}")
        lib = _kernels.open_library(OUT_DIR / f"lib{name}.so", sig)
        if hasattr(lib, "hfvo_hough_launch_shape"):
            restype, argtypes = lines._HOUGH_SIGNATURES["hfvo_hough_launch_shape"]
            lib.hfvo_hough_launch_shape.restype = restype
            lib.hfvo_hough_launch_shape.argtypes = argtypes
        info = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        libs[name] = (lib, info + [f"shared-memory atomics in the SASS: {_atomics(OUT_DIR / f'lib{name}.so')}"],
                      _kernels.spill_bytes(log), is_source)
    return libs


def _atomics(path: Path) -> dict:
    """{opcode: count} of the shared-memory atomics (ATOMS*) that cuobjdump
    finds in a built library's SASS; a float add shows as a compare-and-swap
    loop (ATOMS.CAST.SPIN)."""
    from hfvo_tpu_torch.ops import _kernels

    sass = subprocess.run([str(Path(_kernels.nvcc_path()).parent / "cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    found = re.findall(r"\bATOMS\.[A-Z0-9_.]+", sass)
    return {op: found.count(op) for op in sorted(set(found))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hough_ablation: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    from hfvo_tpu_torch.ops import image, lines
    from hfvo_tpu_torch.testing import synthetic

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    libs = build()
    dev = torch.device("cuda", 0)
    stack = torch.stack([cs._tracked_gray(dev, synthetic.render_sequence(n=2, seed=s, device=dev)[1][1])
                         for s in range(8)])

    def grads(img):
        gx, gy = image.sobel_gradients(img)
        return (torch.sqrt(gx * gx + gy * gy).contiguous(),
                torch.remainder(torch.atan2(gy, gx), torch.pi).contiguous())

    noise8 = torch.from_numpy(np.random.default_rng(3).uniform(0, 255, tuple(stack.shape)).astype(np.float32))
    inputs = {"frame": grads(stack[0].contiguous()), "noise": grads(cs._noise(dev)), "stack": grads(stack),
              "noise_stack": grads(noise8.to(dev))}
    plain = {k: lines.hough_vote_reference(m, a, 12.0) for k, (m, a) in inputs.items()}
    s_tiles = plain["stack"].shape[0] * plain["stack"].shape[1]
    stack_bytes = 8.0 * s_tiles * lines.TILE * lines.TILE + 4.0 * plain["stack"].numel()
    votes = {k: float((lines.to_tiles(inputs[k][0]) > 12.0).float().mean()) for k in ("stack", "noise_stack")}
    print(f"voting share of the tiled pixels: {votes}", flush=True)

    cycles_per_ms = cs._sleep_cycles_per_ms()
    empty_ms = cs.device_ms(lambda: torch.cuda._sleep(0), cycles_per_ms)[0]
    print(f"an empty launch (torch.cuda._sleep(0)) reads {empty_ms:.5f} ms", flush=True)
    result = {}
    for name, (lib, ptxas, spills, is_source) in libs.items():
        errs = {k: cs.hough_gate(f"{name} {k}", lines._launch(m, a, 12.0, lib=lib), plain[k])
                for k, (m, a) in inputs.items()}
        shape = None
        if hasattr(lib, "hfvo_hough_launch_shape"):
            shape = {k: lines.launch_shape(*inputs[k][0].reshape(-1, 480, 640).shape, device=dev, lib=lib)
                     for k in ("frame", "stack")}
        result[name] = {"source": is_source, "max_rel_err": {k: e[0] for k, e in errs.items()},
                        "top4_tiles_checked": {k: e[1] for k, e in errs.items()},
                        "ptxas": ptxas, "spill_bytes": spills, "launch": shape, "rounds": []}
        print(f"{name}{' (the source)' if is_source else ''}: {result[name]['max_rel_err']}, "
              f"ptxas {ptxas}, launch {shape}", flush=True)
    (fm, fa), (sm, sa), (nm, na) = inputs["frame"], inputs["stack"], inputs["noise_stack"]
    for _ in range(2):
        for name, (lib, _, _, _) in libs.items():
            r = {"K3_ms": cs.device_ms(lambda: lines._launch(fm, fa, 12.0, lib=lib), cycles_per_ms)[0],
                 "K3b_ms": cs.device_ms(lambda: lines._launch(sm, sa, 12.0, lib=lib), cycles_per_ms)[0],
                 "K3b_no_votes_ms": cs.device_ms(lambda: lines._launch(sm, sa, math.inf, lib=lib),
                                                 cycles_per_ms)[0],
                 "K3b_noise_ms": cs.device_ms(lambda: lines._launch(nm, na, 12.0, lib=lib), cycles_per_ms)[0]}
            r["K3b_GBps"] = stack_bytes / r["K3b_ms"] / 1e6
            result[name]["rounds"].append(r)
            print(f"{name}: " + ", ".join(f"{k} {v:.5f}" for k, v in r.items()), flush=True)
    for v in result.values():
        v["median"] = {k: float(np.median([r[k] for r in v["rounds"]])) for k in v["rounds"][0]}
    line = json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "voting_share": votes,
                       "empty_launch_ms": empty_ms, "variants": result})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(card)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
