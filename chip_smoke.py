#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`hfvo_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It imports only `hfvo_tpu_torch`, torch and numpy, and needs no JAX, no
dataset and no network: frames come from the port's synthetic renderer.

1. Setup: the card's name and power limit, the torch and CUDA versions, and
   the build of every kernel of the path from `hfvo_tpu_torch/csrc/`.
2. Kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, timed with CUDA events.
3. Main path: points-only `VOSystem.track_rgbd` at full size over the
   renderer's 25-frame orbit at 640x480. The launch counts are set to 0 just
   before this run and read just after; every kernel of the path must have
   launched in it.
4. Output check: no LOST frame, finite poses, ATE RMSE within the gate, and
   the first frames agree with the same system run on the CPU (where every
   wrapper takes its plain version).

Any failed phase raises, and the script exits non-zero without the final
line. It prints the kernel table as one JSON line, then the card's
`nvidia-smi` name and power limit, then as the last line
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# 1.5x the JAX package's 0.0083 m on the same configuration and frames.
ATE_GATE_M = 0.0125
N_FRAMES = 25
# Kernel vs plain version: identical corner masks, values within 2e-3 and no
# relative slack. That is 2 ulp for every score past the 1e4 bonus (float32's
# ulp is 2**-10 over [8192, 16384), where they all lie). Both add the same terms in the same order without multiplies,
# so the kernel has measured bit-equal; the 2 ulp leave room for a compiler
# that reorders the sums, and for nothing more.
K1_ATOL = 2e-3
# CUDA vs CPU run of the same port: the per-frame pose gap allowed between
# two independent float32 runs (as the port's JAX-parity test allows).
CPU_GAP_M, CPU_GAP_DEG, N_CPU_FRAMES = 2e-3, 0.1, 4
TIMING_REPS = 50


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def _sleep_cycles_per_ms() -> float:
    """GPU clock cycles per millisecond, calibrated on torch.cuda._sleep."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def device_ms(fn, cycles_per_ms: float, reps: int = TIMING_REPS):
    """(device ms, call ms) medians over `reps` runs of fn() after a warm-up.

    Device ms: CUDA events around one call that is queued behind a GPU
    sleep longer than the host takes to enqueue it, so the events see only
    the device's work. Call ms: the same events with nothing queued ahead,
    so the host's launch cost shows."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(max(4.0 * host_ms, 0.2) * cycles_per_ms)
    dev, call = [], []
    for queued, acc in ((True, dev), (False, call)):
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if queued:
                torch.cuda._sleep(cycles)
            start.record()
            fn()
            end.record()
            end.synchronize()
            acc.append(start.elapsed_time(end))
    return statistics.median(dev), statistics.median(call)


def check_fast_dual(device, cfg, cycles_per_ms):
    """K1 against its plain version at the main path's shapes: the pyramid
    levels of a rendered 480x640 frame (uint8-truncated, as tracked frames
    are), and 250x330 uniform noise (seed 7). Returns the kernel's table row
    without `launches`."""
    from hfvo_tpu_torch.ops import fast, image
    from hfvo_tpu_torch.testing import synthetic

    _, grays, _ = synthetic.render_sequence(n=1, seed=0, device=device)
    gray = torch.from_numpy(np.clip(grays[0], 0, 255).astype(np.uint8)).to(device).float()
    levels = image.build_pyramid(gray, cfg.orb.n_levels, cfg.orb.scale_factor)
    noise = np.random.default_rng(7).uniform(0, 255, (250, 330)).astype(np.float32)
    imgs = [("level%d" % i, lvl.contiguous()) for i, lvl in enumerate(levels)]
    imgs.append(("noise", torch.from_numpy(noise).to(device)))
    lo, hi = float(cfg.orb.min_th_fast), float(cfg.orb.ini_th_fast)

    max_err, ms_sum, plain_sum = 0.0, 0.0, 0.0
    for name, img in imgs:
        got = fast.fast_score_dual(img, lo, hi)
        want = fast.fast_score_dual_reference(img, lo, hi)
        torch.cuda.synchronize()
        if not torch.equal(got > 0, want > 0) or not torch.equal(got > 1e4, want > 1e4):
            raise AssertionError(f"fast_score_dual {name}: corner set differs from the plain version")
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=0.0, atol=K1_ATOL):
            raise AssertionError(f"fast_score_dual {name}: max abs err {err}")
        max_err = max(max_err, err)
        k_dev, k_call = device_ms(lambda: fast.fast_score_dual(img, lo, hi), cycles_per_ms)
        p_dev, p_call = device_ms(lambda: fast.fast_score_dual_reference(img, lo, hi), cycles_per_ms)
        if name.startswith("level"):
            ms_sum += k_dev
            plain_sum += p_dev
        log(
            f"fast_score_dual {name} {tuple(img.shape)}: corners {int((got > 0).sum())}, "
            f"max_abs_err {err:.3g}; device ms kernel {k_dev:.5f} plain {p_dev:.5f}; "
            f"call ms kernel {k_call:.5f} plain {p_call:.5f}"
        )
    return {
        "name": "fast_score_dual",
        "route": "cuda",
        "source": "hfvo_tpu_torch/csrc/fast_dual.cu",
        "replaces": "hfvo_tpu/ops/pallas_fast.py:84",
        "max_abs_err": max_err,
        "ms": ms_sum,
        "plain_ms": plain_sum,
        "ms_is": f"device time per extraction: sum over the {len(levels)} pyramid levels of 480x640",
    }


def run_system(device, cfg, grays, depths, n):
    """Drive VOSystem.track_rgbd over the first `n` frames. Returns
    (system, results, per-frame wall seconds)."""
    from hfvo_tpu_torch.system import VOSystem

    system = VOSystem(cfg, device, use_local_ba=False, use_loop_closing=False)
    results, secs = [], []
    for i in range(n):
        t0 = time.perf_counter()
        results.append(system.track_rgbd(grays[i], depths[i], i / 30.0))
        secs.append(time.perf_counter() - t0)
    return system, results, secs


def pose_gap(Ta, Tb):
    D = Ta @ np.linalg.inv(Tb)
    rot = np.degrees(np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)))
    return float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])), float(rot)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    import hfvo_tpu_torch  # noqa: F401  (fp32 policy)
    from hfvo_tpu_torch.config import points_only, tum3_config
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.ops import _kernels, fast
    from hfvo_tpu_torch.testing import synthetic
    from hfvo_tpu_torch.tracking.tracker import TrackState

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 1. Build every kernel from the checkout's sources.
    t0 = time.perf_counter()
    _kernels.build("fast_dual")
    log(f"built kernels ['fast_dual'] in {time.perf_counter() - t0:.3f} s")

    cfg = points_only(tum3_config())
    c = cfg.cap
    log(
        f"config: points-only tum3, n_features {cfg.orb.n_features}, {cfg.orb.n_levels} levels, "
        f"cap.keypoints {c.keypoints}, cap.local_points {c.local_points}, cap.map_points {c.map_points}"
    )

    # 2. Kernels against their plain versions.
    k1 = check_fast_dual(device, cfg, _sleep_cycles_per_ms())

    # 3. The main path, with the launch counts read around it alone.
    t0 = time.perf_counter()
    T_wc, grays, depths = synthetic.render_sequence(n=N_FRAMES, seed=0, device=device)
    log(f"rendered {N_FRAMES} frames of 640x480 on the card in {time.perf_counter() - t0:.3f} s")
    fast.fast_dual_launches = 0
    system, results, secs = run_system(device, cfg, grays, depths, N_FRAMES)
    torch.cuda.synchronize()
    launches = fast.fast_dual_launches
    stages = system.tracker.stage_times
    extractions = stages.get("init_extract", [0, 0])[1] + stages.get("fused_step", [0, 0])[1]
    if launches == 0 or launches != cfg.orb.n_levels * extractions:
        raise AssertionError(
            f"fast_score_dual launched {launches} times for {extractions} extractions "
            f"of {cfg.orb.n_levels} levels"
        )
    k1["launches"] = launches

    # 4. The output.
    states = [r.state for r in results]
    n_lost = sum(s is not TrackState.OK for s in states)
    est = system.get_trajectory()
    if est.shape != (N_FRAMES, 4, 4) or not np.isfinite(est).all():
        raise AssertionError(f"trajectory of shape {est.shape}, finite {np.isfinite(est).all()}")
    ts = np.arange(N_FRAMES) / 30.0
    ate = evaluate.ate(ts, T_wc, ts, est, align="origin").rmse
    n_kf = sum(r.is_keyframe for r in results)
    tracked_ms = np.array(secs[1:]) * 1e3
    log(
        f"main path: {N_FRAMES} frames, LOST {n_lost}, keyframes {n_kf}, ATE RMSE {ate:.6f} m, "
        f"ms/tracked frame median {np.median(tracked_ms):.3f} p90 {np.percentile(tracked_ms, 90):.3f} "
        f"(init frame {secs[0] * 1e3:.3f} ms)"
    )
    log("stages: " + system.extract_times().replace("\n", "; "))
    if n_lost:
        raise AssertionError(f"{n_lost} frames not tracked: {[s.name for s in states]}")
    if not ate <= ATE_GATE_M:
        raise AssertionError(f"ATE RMSE {ate} m above the {ATE_GATE_M} m gate")

    _, cpu_results, _ = run_system("cpu", cfg, grays, depths, N_CPU_FRAMES)
    for i, (a, b) in enumerate(zip(results, cpu_results)):
        dt, dr = pose_gap(a.T_cw, b.T_cw)
        log(f"frame {i}: card vs CPU {dt * 1e3:.4f} mm {dr:.5f} deg, matches {a.n_matches} vs {b.n_matches}")
        if not (dt < CPU_GAP_M and dr < CPU_GAP_DEG) or a.is_keyframe != b.is_keyframe:
            raise AssertionError(f"frame {i}: the card's run departs from the CPU run")

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": [k1]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
