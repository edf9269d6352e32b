#!/usr/bin/env python3
"""Ablation of the FAST kernels' design (`hfvo_tpu_torch/csrc/fast_dual.cu`) on the GPU.

    python3 fast_ablation.py [--out FILE]

Builds the source as it is and variants of it that each undo one design
step (one nvcc per variant, all started together, into
`build/fast_ablation/`), holds every variant bit-equal to the plain PyTorch
version on rendered pyramids, 250x330 noise and a ragged list at both
threshold orders, then times each on the card in two interleaved rounds
(CUDA events behind a GPU sleep, as `chip_smoke.py` times):

- K1: one launch over the 8 pyramid levels of one rendered 480x640 frame;
- K1b: one launch over the 8 levels of a stack of 8 frames (frame 1 of the
  orbits of seeds 0-7, as `chip_smoke.py` stacks them);
- the 480x640 level of the stack alone, with its GB/s (8 B a pixel).

Variants: `design` (the source); `window_7x7` (step 2 in its
register-window form: each thread keeps a 7x7 window and runs the full test
inline at every strip step); `no_early_exit` (every pixel row through the
full test: step 3 off). Step 1's share, one launch against 8 one-level
launches of the same kernel, is timed by `chip_smoke.py`. Also the
per-level pass rates of the early exit's test. Prints the card's name and
power limit, then one JSON line. Needs one CUDA device and nvcc; imports no
JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "hfvo_tpu_torch" / "csrc" / "fast_dual.cu"
OUT_DIR = ROOT / "build" / "fast_ablation"

_PASSES_START = "  // Pass 1, the early exit:"
_KERNEL_END = "}\n\n}  // namespace"
# Step 2 in its register-window form: a 7x7 window rolls down the strip and
# the full test runs inline at each step where a lane passes the pre-test.
_WINDOW_BODY = r'''  float th[NTH];
  th[0] = th_low;
  if (NTH == 2) th[NTH - 1] = th_high;
  float win[7][7];
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int j = 0; j < 7; ++j) win[r + 1][j] = col[r * SM_W + j];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int j = 0; j < 7; ++j) win[r][j] = win[r + 1][j];
#pragma unroll
    for (int j = 0; j < 7; ++j) win[6][j] = col[(p + 6) * SM_W + j];
    const int y = ys + p;
    const bool inside = x_in && y >= 3 && y < h - 3;
    const float c = win[3][3];
    float res = 0.0f;
    if (__any_sync(FULL_WARP, inside && cardinal_pass(c, th_min, win[0][3], win[3][6], win[6][3], win[3][0]))) {
      const float ring[16] = {win[0][3], win[0][4], win[1][5], win[2][6], win[3][6], win[4][6],
                              win[5][5], win[6][4], win[6][3], win[6][2], win[5][1], win[4][0],
                              win[3][0], win[2][0], win[1][1], win[0][2]};
      const float s = full_score<NTH>(ring, c, th, bonus);
      res = inside ? s : 0.0f;
    }
    if (x < w && y < h) out[y * w + x] = res;
  }
'''


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"fast_ablation: the source no longer holds {old[:60]!r}")
    return src.replace(old, new)


def _window(src: str) -> str:
    """The kernel's two passes replaced by _WINDOW_BODY (str.index raises
    where the source no longer holds an anchor)."""
    i0, i1 = src.index(_PASSES_START), src.index(_KERNEL_END)
    return src[:i0] + _WINDOW_BODY + src[i1:]


VARIANTS = {
    "design": lambda s: s,
    "window_7x7": _window,
    "no_early_exit": lambda s: _sub(s, "if (__any_sync(FULL_WARP, inside && cand))",
                                    "if (true || __any_sync(FULL_WARP, inside && cand))"),
}


def build():
    """{variant: (ctypes library, ptxas register/spill lines)}; raises if a
    build fails."""
    from hfvo_tpu_torch.ops import _kernels, fast

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src, procs = SOURCE.read_text(), {}
    for name, make in VARIANTS.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(make(src))
        cmd = [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(OUT_DIR / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"fast_ablation: {name} failed to build\n{log}")
        lib = _kernels.open_library(OUT_DIR / f"lib{name}.so", fast._FAST_SIGNATURES)
        libs[name] = (lib, [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln])
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fast_ablation: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    from hfvo_tpu_torch.ops import fast, image
    from hfvo_tpu_torch.testing import synthetic

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    libs = build()
    dev = torch.device("cuda", 0)
    stack = torch.stack([cs._tracked_gray(dev, synthetic.render_sequence(n=2, seed=s, device=dev)[1][1])
                         for s in range(8)])

    def pyramid(img):
        return [lvl.contiguous() for lvl in image.build_pyramid(img, 8, 1.2)]

    frame_lv, stack_lv = pyramid(stack[0].contiguous()), pyramid(stack)
    rng = np.random.default_rng(7)
    checks = [frame_lv, stack_lv,
              [torch.from_numpy(rng.uniform(0, 255, (8, 250, 330)).astype(np.float32)).to(dev)],
              [torch.from_numpy(rng.uniform(0, 255, hw).astype(np.float32)).to(dev)
               for hw in ((7, 9), (33, 65), (5, 400), (300, 20), (250, 330))]]
    pass_rates = []
    for x in stack_lv:
        cand = torch.nn.functional.pad(fast.fast_candidates_reference(x, 7.0), (0, (-x.shape[-1]) % 32))
        pass_rates.append({"level": list(x.shape), "pixels": float(cand.float().mean()),
                           "warp_rows": float(cand.reshape(*x.shape[:2], -1, 32).any(-1).float().mean())})
    print(f"pre-test pass rates at th 7 (pixels, 32-px warp rows): {pass_rates}", flush=True)

    cycles_per_ms = cs._sleep_cycles_per_ms()
    result = {}
    for name, (lib, ptxas) in libs.items():
        exact = all(
            torch.equal(got, fast.fast_score_dual_reference(x, lo, hi) if n_th == 2
                        else fast.fast_score_reference(x, lo))
            for lo, hi in ((7.0, 20.0), (20.0, 7.0)) for lv in checks for n_th in (1, 2)
            for got, x in zip(fast._launch_levels(lv, n_th, lo, hi, 1e4, lib=lib), lv)
        )
        if not exact:
            raise AssertionError(f"fast_ablation: variant {name} differs from the plain version")
        result[name] = {"exact": exact, "ptxas": ptxas, "rounds": []}
    for _ in range(2):
        for name, (lib, _) in libs.items():
            timed = {
                "K1_ms": lambda: fast._launch_levels(frame_lv, 2, 7.0, 20.0, 1e4, lib=lib),
                "K1b_ms": lambda: fast._launch_levels(stack_lv, 2, 7.0, 20.0, 1e4, lib=lib),
                "K1b_480x640x8_ms": lambda: fast._launch_levels(stack_lv[:1], 2, 7.0, 20.0, 1e4, lib=lib),
            }
            r = {k: cs.device_ms(fn, cycles_per_ms)[0] for k, fn in timed.items()}
            r["K1b_480x640x8_GBps"] = 8.0 * stack_lv[0].numel() / r["K1b_480x640x8_ms"] / 1e6
            result[name]["rounds"].append(r)
            print(f"{name}: " + ", ".join(f"{k} {v:.5f}" for k, v in r.items()), flush=True)
    line = json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "pre_test": pass_rates,
                       "variants": result})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(card)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
