#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`hfvo_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It imports only `hfvo_tpu_torch`, torch and numpy, and needs no JAX, no
dataset and no network: frames come from the port's synthetic renderer.

1. Setup: the card's name and power limit, the torch and CUDA versions, and
   the build of every kernel of the paths from `hfvo_tpu_torch/csrc/` (one
   nvcc per source, all started together), with ptxas's registers and
   spills; the Hough vote must spill nothing.
2. Kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, timed with CUDA events, beside its bound
   (the larger of its bytes over 3.35 TB/s and its operations over the
   card's float32 peak) and, where one PyTorch call computes the same
   function, that call's time. K1 (FAST, one launch over the 8 pyramid
   levels of a frame; also timed as 8 one-level launches and level by
   level) and K3 (Hough vote, one image) on a frame and on noise; K1b, K2b
   and K3b (the same on a stack of 8 frames, one per sequence of the batch
   path) and K2 (FAST at one threshold) on the pyramid levels of those
   frames. The Hough vote's cluster shape and grid are printed, and its
   refusals checked to launch nothing.
3. The points path: points-only `VOSystem.track_rgbd` over the renderer's
   25-frame orbit at 640x480.
4. The lines path: point + line `VOSystem.track_rgbd` over the same frames.
5. The full path, the main path of the system: `VOSystem.track_rgbd` with
   the JAX package's default tracking step (lines, planes and Manhattan
   axes; `config.full_step`) over the same frames, at every width of tum3
   (cap.planes 32).
6. The default path, the JAX package's default system: `VOSystem(
   tum3_config(), use_local_ba=True, use_loop_closing=False)` (the full
   step plus the keyframe path: point and line triangulation, local BA)
   over the same frames; the points and lines it triangulates a keyframe,
   its local BA runs and their ms.
7. The low-texture room of the JAX suite's `test_low_texture.py` (20 orbit
   frames), tracked by a points-only and by the default configuration,
   each on a fresh `Tracker` with local BA; local BA's runs and ms.
8. The batch paths, `BatchTracker.track_batch` of 8 sequences (orbits of
   seeds 0-7) over 25 frames at 640x480: point + line tracking; the full
   step (`tum3_config()`, the JAX benchmark's batch configuration); the
   full step with local BA after each keyframe.
   For each path the launch counts are set to 0 just before its run and
   read just after; every kernel of the path must have launched in it, once
   per call of its function (FAST: once an extraction, for all levels).
9. Output checks, per path: no LOST frame, finite poses, ATE RMSE within the
   gate, the first frames agree with the same system run on the CPU (where
   every wrapper takes its plain version), with the same keyframes; on the
   lines, full, default and batch paths, enough inlier line matches; on
   the full and default paths, the Manhattan frame valid from the JAX
   run's frame and enough inlier full plane matches (batch: per
   sequence); on the low-texture room, the hybrid's ATE under 0.6x the
   points-only's and under 0.05 m (the JAX suite's gates); local BA run
   at least 3 times on the low-texture room and on the batch with BA.
   The keyframe path's own work: on the default path and the low-texture
   room, as many points and lines triangulated as the JAX package's run;
   from the default path's final map with a third of the newest keyframe's
   points and lines erased, triangulation on the card against the CPU and
   against the erased points (check_triangulation); in every local BA run,
   a lower cost at the end than at the start, and the first and last runs
   of the low-texture room and of the batch solved again on the CPU from
   the captured problem (check_ba).

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

N_FRAMES = 25
# Points path: 1.5x the JAX package's 0.0083 m on the same configuration
# and frames. Lines path: 1.5x its 0.00803 m.
ATE_GATE_POINTS_M = 0.0125
ATE_GATE_LINES_M = 0.012
# Lines path: inlier line matches over frames 1-24, 75 % of the JAX
# package's 117 on the same run.
MIN_LINE_INLIERS = 88
# Full path, from the JAX package's run of the same configuration and frames
# on the CPU (`full_reference_jax.py`): ATE RMSE, the first frame with a
# valid Manhattan frame, and the inlier full plane matches and inlier line
# matches over frames 1-24. Gates: ATE <= 1.5x, the same first Manhattan
# frame, matches >= 75 %.
JAX_FULL_ATE_M = 0.007006
JAX_FULL_MANH_FIRST_FRAME = 0
JAX_FULL_PLANE_INLIERS = 24
JAX_FULL_LINE_INLIERS = 109
# Batch path, per sequence s = 0..7 (orbit seed s): the JAX package's
# BatchTracker on the same configuration and frames, on the CPU
# (`batch_reference_jax.py`): ATE RMSE in metres, and inlier line matches
# over frames 1-24. Gates: ATE <= min(1.5x, 0.02 m), inliers >= 75 %.
N_SEQ = 8
JAX_BATCH_ATE_M = (0.005508, 0.004406, 0.005553, 0.004252, 0.004912, 0.007420, 0.003628, 0.005830)
JAX_BATCH_LINE_INLIERS = (288, 304, 394, 369, 315, 295, 300, 327)
# Default path (the JAX package's default system without loop closing):
# the same run on the CPU, `full_reference_jax.py --config default`: ATE
# 0.00700598 m on the orbit (3 keyframes, no local BA run: BA needs 4);
# the Manhattan frame, plane and line numbers are the full path's. Gate:
# ATE <= min(1.5x, 0.02 m), the north star's gate of tests/test_tracker.py.
JAX_DEFAULT_ATE_M = 0.007006
# Points and lines the keyframe path triangulated over the run, same script
# (0 and 0: depth landmarks every keypoint of the rendered rooms); the port
# must create as many, within 2 %. The orbit's, then the low-texture room's
# (its points-only run triangulates no lines).
JAX_DEFAULT_TRIANGULATED = {"points": 0, "lines": 0}
JAX_LOW_TEXTURE_TRIANGULATED = {"points_only": {"points": 0, "lines": 0}, "hybrid": {"points": 0, "lines": 0}}
# Low-texture room (tests/test_low_texture.py, the same script): ATE of the
# points-only and of the default configuration, each with local BA, in
# metres. The gates are the test's own: hybrid < 0.6x points-only and
# < 0.05 m, on this run's numbers; the JAX numbers are printed beside them.
LOW_TEXTURE_FRAMES = 20
JAX_LOW_TEXTURE_ATE_M = {"points_only": 0.360433, "hybrid": 0.013193}
# Batch of the full step (the JAX benchmark's batch configuration,
# `batch_reference_jax.py --config full`), per sequence: ATE RMSE, inlier
# line matches and inlier full plane matches over frames 1-24; with local
# BA: ATE RMSE and local BA runs. Gates: ATE <= min(1.5x, 0.02 m), line
# matches >= 75 %, and with BA at least 3 runs a sequence. Plane matches:
# each sequence matches the first wall in every tracked frame (24); a
# second map plane, which adds ~11 more, exists only where a keyframe falls
# on the frames where the second wall is first segmented, so its count is
# 24 or ~35 by a one-match margin of the keyframe ratio rule (the JAX runs
# themselves give sequences 6 and 7 35 and 24 with BA off and 24 and 35
# with it on; on the CPU the port's sequence 3 takes its keyframe a frame
# after the JAX package's, with 540 matches against a 539.25 threshold).
# So a sequence must reach min(75 % of JAX's, 24), at least 6 of the 8
# must reach 75 % of JAX's own count (at most two may miss the second
# wall), and the 8 together 75 % of JAX's sum.
JAX_BATCH_FULL_ATE_M = (0.004935, 0.003831, 0.006482, 0.005784, 0.005225, 0.005842, 0.006729, 0.004800)
JAX_BATCH_FULL_LINE_INLIERS = (285, 303, 400, 368, 317, 323, 313, 319)
JAX_BATCH_FULL_PLANE_INLIERS = (36, 35, 35, 35, 35, 36, 35, 24)
JAX_BATCH_BA_ATE_M = (0.006051, 0.011877, 0.012157, 0.006913, 0.008101, 0.010664, 0.011097, 0.012925)
JAX_BATCH_BA_RUNS = (7, 6, 5, 5, 6, 8, 6, 7)
MIN_BA_RUNS = 3
MIN_PLANE_SEQS = 6
# Sequences whose first frames are checked against a batch of them on the CPU.
CPU_BATCH_SEQS = (0, 7)
# Kernel vs plain version, K1: identical corner masks, values within 2e-3 and no
# relative slack. That is 2 ulp for every score past the 1e4 bonus (float32's
# ulp is 2**-10 over [8192, 16384), where they all lie). Both add the same terms in the same order without multiplies,
# so the kernel has measured bit-equal; the 2 ulp leave room for a compiler
# that reorders the sums, and for nothing more.
K1_ATOL = 2e-3
# K3: |kernel - plain| / max(|plain|, 1). Shared-memory float atomics add the
# votes in a run-dependent order, so only float32 rounding of the sums is
# allowed; the bins themselves must agree (checked through the top-4 peaks).
K3_RTOL = 1e-4
# CUDA vs CPU run of the same port: the per-frame pose gap allowed between
# two independent float32 runs (as the port's JAX-parity tests allow).
CPU_GAP_M, CPU_GAP_DEG, N_CPU_FRAMES = 2e-3, 0.1, 4
TIMING_REPS = 50
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 (non-tensor) rate.
HBM_BYTES_PER_MS = 3.35e12 / 1e3
F32_OPS_PER_MS = 67e12 / 1e3


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


def bound(bytes_moved: float, operations: float):
    """(bound ms, bound_by): the least time the card could take."""
    b_ms, o_ms = bytes_moved / HBM_BYTES_PER_MS, operations / F32_OPS_PER_MS
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def _tracked_gray(device, gray_np):
    """A rendered frame as the tracker sees it: uint8-truncated, float32."""
    return torch.from_numpy(np.clip(gray_np, 0, 255).astype(np.uint8)).to(device).float()


def _noise(device):
    return torch.from_numpy(np.random.default_rng(7).uniform(0, 255, (250, 330)).astype(np.float32)).to(device)


# Kernel row name -> (id, module, launch counter, the TPU kernel it replaces).
# Every wrapper adds one to its counter where it launches its kernel,
# whatever S is.
KERNELS = {
    "fast_score_dual": ("K1", "fast", "fast_dual_launches", "hfvo_tpu/ops/pallas_fast.py:84"),
    "fast_score_dual_batched": ("K1b", "fast", "fast_dual_batched_launches",
                                "hfvo_tpu/ops/pallas_fast.py:225"),
    "fast_score": ("K2", "fast", "fast_score_launches", "hfvo_tpu/ops/pallas_fast.py:132"),
    "fast_score_batched": ("K2b", "fast", "fast_score_batched_launches",
                           "hfvo_tpu/ops/pallas_fast.py:151"),
    "hough_vote": ("K3", "lines", "hough_vote_launches", "hfvo_tpu/ops/pallas_hough.py:45"),
    "hough_vote_batched": ("K3b", "lines", "hough_vote_batched_launches",
                           "hfvo_tpu/ops/pallas_hough.py:123"),
}


def _counter_module(name):
    from hfvo_tpu_torch.ops import fast, lines

    return {"fast": fast, "lines": lines}[name]


def reset_counts() -> None:
    for _, mod, attr, _ in KERNELS.values():
        setattr(_counter_module(mod), attr, 0)


def read_counts() -> dict:
    return {k: getattr(_counter_module(mod), attr) for k, (_, mod, attr, _) in KERNELS.items()}


def _row(name, source, **numbers):
    kid, _, _, replaces = KERNELS[name]
    return {"name": name, "id": kid, "route": "cuda", "source": source, "replaces": replaces, **numbers}


def check_fast(device, cfg, cycles_per_ms, gray_np, stack):
    """The FAST kernels against their plain versions at the main paths'
    shapes, each launch over a list of levels: K1 and K2 on the 8 pyramid
    levels of a rendered 480x640 frame plus 250x330 uniform noise (seed 7);
    K1b and K2b on the levels of the stack of 8 frames plus a stack of 8
    noise images (seed 8). Times one launch over the 8 levels and, as an ablation,
    the same kernel in 8 one-level launches and each level alone. Returns
    their table rows without `launches`; K2's and K2b's `launches_by_path`
    get the counts of their entry point, `pyramid_fast_scores`, on the frame
    and on the stack."""
    from hfvo_tpu_torch.ops import fast, image

    def pyramid(img):
        return [lvl.contiguous() for lvl in image.build_pyramid(img, cfg.orb.n_levels, cfg.orb.scale_factor)]

    frame = _tracked_gray(device, gray_np)
    noise = _noise(device)
    lo, hi = float(cfg.orb.min_th_fast), float(cfg.orb.ini_th_fast)
    dual = (lambda lv: fast.fast_score_dual_levels(lv, lo, hi), lambda x: fast.fast_score_dual_reference(x, lo, hi))
    single = (lambda lv: fast.fast_score_levels(lv, lo), lambda x: fast.fast_score_reference(x, lo))
    # name -> ((kernel on a list of levels, plain version of one level),
    # the timed levels, a level only checked, thresholds)
    noise_stack = torch.from_numpy(
        np.random.default_rng(8).uniform(0, 255, (stack.shape[0],) + tuple(noise.shape)).astype(np.float32)
    ).to(device)
    cases = {
        "fast_score_dual": (dual, pyramid(frame), noise, 2),
        "fast_score_dual_batched": (dual, pyramid(stack), noise_stack, 2),
        "fast_score": (single, pyramid(frame), noise, 1),
        "fast_score_batched": (single, pyramid(stack), noise_stack, 1),
    }
    rows = {}
    for name, ((kern, plain), levels, extra, n_th) in cases.items():
        checked = levels + [extra]
        max_err = 0.0
        for x, got in zip(checked, kern(checked)):
            want = plain(x)
            torch.cuda.synchronize()
            if not torch.equal(got > 0, want > 0) or not torch.equal(got > 1e4, want > 1e4):
                raise AssertionError(f"{name} {tuple(x.shape)}: corner set differs from the plain version")
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=0.0, atol=K1_ATOL):
                raise AssertionError(f"{name} {tuple(x.shape)}: max abs err {err}")
            max_err = max(max_err, err)
        ms, call = device_ms(lambda: kern(levels), cycles_per_ms)
        split_ms, split_call = device_ms(lambda: [kern([x]) for x in levels], cycles_per_ms)
        plain_ms, _ = device_ms(lambda: [plain(x) for x in levels], cycles_per_ms, reps=10)
        per_level = []
        for x in levels:
            x_ms, _ = device_ms(lambda: kern([x]), cycles_per_ms)
            per_level.append(x_ms)
            log(f"{name} {tuple(x.shape)} alone: device ms {x_ms:.5f}, {8.0 * x.numel() / x_ms / 1e6:.1f} GB/s")
        pixels = sum(x.numel() for x in levels)
        # Bytes: each pixel read once and its score written once (8 B). Work:
        # per threshold 16 ring pixels x (2 compares, ~2 adds).
        bound_ms, bound_by = bound(8.0 * pixels, n_th * 16 * 4.0 * pixels)
        log(f"{name}: {len(levels)} levels {tuple(levels[0].shape)}..{tuple(levels[-1].shape)}, max_abs_err "
            f"{max_err:.3g} (noise too); device ms one launch {ms:.5f}, 8 one-level launches {split_ms:.5f}, "
            f"levels alone summed {sum(per_level):.5f}, plain {plain_ms:.5f}, bound {bound_ms:.6f} ({bound_by}); "
            f"call ms one launch {call:.5f}, 8 launches {split_call:.5f}")
        what = "one 480x640 frame" if levels[0].dim() == 2 else f"{stack.shape[0]} 480x640 frames"
        rows[name] = _row(
            name, "hfvo_tpu_torch/csrc/fast_dual.cu", max_abs_err=max_err, ms=ms, call_ms=call,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            ms_is=f"device time of one launch over the {len(levels)} pyramid levels of {what}",
            ablation={"one_level_launches_ms": split_ms, "one_level_launches_call_ms": split_call,
                      "levels_alone_ms": per_level},
        )
    # K2's entry point (the JAX package's "pyramid + 2x fast_score" probe):
    # one launch a threshold.
    for name, img in (("fast_score", frame), ("fast_score_batched", stack)):
        reset_counts()
        fast.pyramid_fast_scores(img, lo, hi, cfg.orb.n_levels, cfg.orb.scale_factor)
        torch.cuda.synchronize()
        n = read_counts()[name]
        if n != 2:
            raise AssertionError(f"pyramid_fast_scores launched {name} {n} times")
        rows[name]["launches_by_path"] = {"pyramid_fast_scores": n}
    return rows


def check_hough(device, cycles_per_ms, gray_np, stack):
    """K3 on the 70 tiles of a rendered 480x640 frame (its Sobel magnitude
    and angle, as detect_lines computes them) and on the 15 tiles of
    250x330 noise; K3b on the 560 tiles of the stack of 8 frames, one
    launch, also held to K3 on its last frame alone; the wrapper's
    refusals, with no launch. Prints each launch's cluster shape and grid.
    Returns their table rows without `launches`."""
    from hfvo_tpu_torch.ops import image, lines

    def grads(img):
        gx, gy = image.sobel_gradients(img)
        return (torch.sqrt(gx * gx + gy * gy).contiguous(),
                torch.remainder(torch.atan2(gy, gx), torch.pi).contiguous())

    before = read_counts()
    z = torch.zeros((128, 192), device=device)
    for bad in ((z.double(), z.double()), (z[None, None], z[None, None]), (z.t(), z.t()), (z, z[:64])):
        try:
            lines.hough_vote(*bad, 12.0)
        except ValueError:
            continue
        raise AssertionError(f"hough_vote took {tuple(bad[0].shape)}, {tuple(bad[1].shape)} "
                             f"{bad[0].dtype}, contiguous {bad[0].is_contiguous()}")
    if read_counts() != before:
        raise AssertionError("hough_vote launched on inputs it refused")

    rows = {}
    for name, label, img in (("hough_vote", "frame", _tracked_gray(device, gray_np)),
                             ("hough_vote", "noise", _noise(device)),
                             ("hough_vote_batched", "stack", stack)):
        mag, ang = grads(img)
        shape = lines.launch_shape(*mag.reshape(-1, *mag.shape[-2:]).shape, device=device)
        log(f"{name} {label} launch: clusters of {shape['cluster']} blocks x {shape['threads']} threads, "
            f"grid ({shape['grid_x']}, {shape['grid_y']}, {shape['grid_z']}) = "
            f"{shape['grid_x'] * shape['grid_y'] * shape['grid_z']} blocks, "
            f"{shape['max_active_clusters']} clusters resident at most")
        got = lines.hough_vote(mag, ang, 12.0)
        want = lines.hough_vote_reference(mag, ang, 12.0)
        rel, n_checked = hough_gate(f"{name} {label}", got, want)
        if name == "hough_vote_batched":
            alone = lines.hough_vote(mag[-1].contiguous(), ang[-1].contiguous(), 12.0)
            rel = max(rel, hough_gate(f"{name} {label}, last frame alone", alone, got[-1])[0])
        g = got.reshape(-1, lines.N_THETA * lines.N_RHO)
        k_dev, k_call = device_ms(lambda: lines.hough_vote(mag, ang, 12.0), cycles_per_ms)
        p_dev, p_call = device_ms(lambda: lines.hough_vote_reference(mag, ang, 12.0), cycles_per_ms, reps=20)
        # Yardstick: one bincount over the precomputed flat bins and weights
        # of all votes (it leaves out the bin computation itself).
        idx, wts = _flat_votes(mag, ang)
        n_bins = got.numel()
        l_dev, _ = device_ms(lambda: torch.bincount(idx, weights=wts, minlength=n_bins), cycles_per_ms)
        tiled_px, n_votes = g.shape[0] * lines.TILE * lines.TILE, int(idx.numel())
        # Bytes: mag and angle over the tiled region (8 B a pixel) and the
        # accumulators written once. Work: ~3 operations a pixel for its
        # theta bin, ~8 a vote for rho, its bin and the add.
        b_ms, b_by = bound(8.0 * tiled_px + 4.0 * n_bins, 3.0 * tiled_px + 8.0 * n_votes)
        log(f"{name} {label} {tuple(img.shape)}: {g.shape[0]} tiles, {n_votes} votes, max_rel_err {rel:.3g}, "
            f"top-4 checked in {n_checked} tiles; device ms kernel {k_dev:.5f} plain {p_dev:.5f} bincount "
            f"{l_dev:.5f} (bins precomputed, not timed); call ms kernel {k_call:.5f} plain {p_call:.5f}; "
            f"bound ms {b_ms:.6f} ({b_by})")
        if label == "noise":
            continue
        rows[name] = _row(
            name, "hfvo_tpu_torch/csrc/hough_vote.cu", max_abs_err=float((got - want).abs().max()),
            max_rel_err=rel, ms=k_dev, call_ms=k_call, plain_ms=p_dev, bound_ms=b_ms, bound_by=b_by,
            library_ms=l_dev, launch=shape,
            ms_is=f"device time per detect_lines call ({g.shape[0]} tiles of {mag.shape[0] if mag.dim() == 3 else 1} "
                  "480x640 frame(s)); library_ms is torch.bincount on precomputed bins, without the "
                  "bin computation")
    return rows


def hough_gate(what, got, want):
    """(max relative error, tiles whose top-4 bins were checked) of Hough
    accumulators against the plain version's; raises where the error
    exceeds K3_RTOL or the top-4 bins differ in a tile whose 4th and 5th
    plain values are more than K3_RTOL apart."""
    from hfvo_tpu_torch.ops import lines

    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
    if not rel <= K3_RTOL:
        raise AssertionError(f"{what}: max relative err {rel}")
    g = got.reshape(-1, lines.N_THETA * lines.N_RHO).cpu().numpy()
    w = want.reshape(-1, lines.N_THETA * lines.N_RHO).cpu().numpy()
    n_checked = 0
    for k in range(w.shape[0]):
        srt = np.sort(w[k])[::-1]
        if srt[3] - srt[4] > K3_RTOL * max(abs(srt[3]), 1.0):
            n_checked += 1
            if set(np.argsort(w[k])[-4:]) != set(np.argsort(g[k])[-4:]):
                raise AssertionError(f"{what}: tile {k} top-4 bins differ")
    return rel, n_checked


def _flat_votes(mag, ang):
    """(flat bin index, weight) of every vote of the plain version; a stack
    (S, H, W) is one list of S * T tiles."""
    from hfvo_tpu_torch.ops import lines

    m_t = lines.to_tiles(mag).reshape(-1, lines.TILE * lines.TILE)
    na_t = lines.to_tiles(ang).reshape(-1, lines.TILE * lines.TILE)
    tile = torch.arange(m_t.shape[0], device=mag.device)[:, None] * (lines.N_THETA * lines.N_RHO)
    on = m_t > 12.0
    idx, wts = [], []
    for (t, rb), scale in zip(lines.vote_bins(na_t), (1.0, 0.5, 0.5)):
        idx.append((tile + t * lines.N_RHO + rb)[on])
        wts.append((m_t * scale)[on])
    return torch.cat(idx), torch.cat(wts)


# The keyframe-path log of the local BA run in progress, which the wrapper
# of `local_bundle_adjustment` fills (see keyframe_path_log).
_BA_RUN_LOG = []


def _capture_ba() -> None:
    """Wrap the mapper module's `local_bundle_adjustment` (once) so that each
    run appends its (problem, result) to the keyframe-path log of the run in
    progress. It only keeps references: nothing is pulled to the host."""
    from hfvo_tpu_torch.mapping import local_mapping

    fn = local_mapping.local_bundle_adjustment
    if getattr(fn, "_captures", False):
        return

    def wrapped(prob, intr):
        res = fn(prob, intr)
        if _BA_RUN_LOG:
            _BA_RUN_LOG[-1]["ba"].append((prob, res))
        return res

    wrapped._captures = True
    local_mapping.local_bundle_adjustment = wrapped


def keyframe_path_log(tracker) -> dict:
    """Record, for this tracker's local mapper, the points and lines each
    triangulation creates, the wall ms of each local BA run that ran (it
    ends in a host pull, so the time holds its device work) and each run's
    problem and result (for check_ba). Wraps the instance's methods;
    returns the dict they fill."""
    _capture_ba()
    mapper = tracker.mapper
    log_ = {"points": [], "lines": [], "ba_ms": [], "ba": []}

    def counting(fn, key):
        def wrapped(*a, **kw):
            n = fn(*a, **kw)
            log_[key].append(int(n))
            return n
        return wrapped

    def timed(fn):
        def wrapped(*a, **kw):
            _BA_RUN_LOG.append(log_)
            t0 = time.perf_counter()
            try:
                ran = fn(*a, **kw)
            finally:
                _BA_RUN_LOG.pop()
            if ran:
                log_["ba_ms"].append((time.perf_counter() - t0) * 1e3)
            return ran
        return wrapped

    mapper.create_new_map_points = counting(mapper.create_new_map_points, "points")
    mapper.create_new_map_lines = counting(mapper.create_new_map_lines, "lines")
    mapper.run_local_ba = timed(mapper.run_local_ba)
    return log_


def ba_summary(name, logs) -> str:
    """One line on the triangulations and local BA runs of `logs`."""
    ba = [ms for lg in logs for ms in lg["ba_ms"]]
    pts = [n for lg in logs for n in lg["points"]]
    lns = [n for lg in logs for n in lg["lines"]]
    ms = f"median {np.median(ba):.3f} min {min(ba):.3f} max {max(ba):.3f}" if ba else "none"
    return (f"{name}: local BA runs {len(ba)}, ms a run {ms}; points triangulated a keyframe "
            f"{pts} ({len(pts)} keyframes), lines {lns}")


def check_triangulated(name, kf_log, jax) -> None:
    """The points and lines the keyframe path triangulated over a run
    against the JAX package's count on the same run, within 2 %."""
    got = {"points": sum(kf_log["points"]), "lines": sum(kf_log["lines"])}
    log(f"{name}: triangulated over the run {got} (JAX {jax})")
    if any(abs(got[k] - jax[k]) > 0.02 * jax[k] for k in got):
        raise AssertionError(f"{name}: triangulated {got}, the JAX package {jax}")


def _ba_on(prob, device):
    from hfvo_tpu_torch.solve.ba import BAProblem

    return BAProblem(*(None if x is None else x.to(device) for x in prob))


def check_ba(name, logs, intr, n_cpu=2) -> None:
    """What local BA did on the card, for every run in `logs`: its cost (the
    LM's objective over the edges of its final inlier set) at the end
    against the same at the start, which must be lower in every run; and
    the first and last `n_cpu` // 2 runs solved again on the CPU from the
    same captured problem, held to the slice test's tolerances
    (test_torch_full_tracker.py::test_f_*): keyframe poses within 5 mm and
    0.1 deg, final cost within 1 %, inlier edges that differ in at most
    0.5 % of the edges."""
    from hfvo_tpu_torch.ops.batch import to_host
    from hfvo_tpu_torch.solve.ba import _chi2_total, local_bundle_adjustment

    runs = [r for lg in logs for r in lg["ba"]]
    if not runs:
        raise AssertionError(f"{name}: no local BA run captured")
    costs = to_host([torch.stack([
        _chi2_total(prob, prob.kf_T_cw, prob.pt_X, intr, res.e_inlier, res.le_inlier),
        _chi2_total(prob, res.kf_T_cw, res.pt_X, intr, res.e_inlier, res.le_inlier)])
        for prob, res in runs])
    ratio = np.array([c1 / c0 for c0, c1 in costs])
    log(f"{name}: local BA cost end/start over its inlier edges, {len(runs)} runs: min {ratio.min():.6f} "
        f"median {np.median(ratio):.6f} max {ratio.max():.6f}")
    if not (ratio < 1.0).all():
        raise AssertionError(f"{name}: local BA runs {np.nonzero(~(ratio < 1.0))[0].tolist()} did not lower "
                             f"their cost: {ratio.tolist()}")
    picks = sorted(set(range(min(n_cpu // 2, len(runs)))) | set(range(max(len(runs) - n_cpu // 2, 0), len(runs))))
    for i in picks:
        prob, res = runs[i]
        cpu = local_bundle_adjustment(_ba_on(prob, "cpu"), intr)
        T_card, chi2_card, e_card, le_card, e_valid, le_valid = to_host(
            [res.kf_T_cw, res.chi2, res.e_inlier, res.le_inlier, prob.e_valid, prob.le_valid])
        gaps = [pose_gap(a, b) for a, b in zip(T_card, cpu.kf_T_cw.numpy())]
        dt, dr = max(g[0] for g in gaps), max(g[1] for g in gaps)
        chi2_cpu = float(cpu.chi2)
        n_e = int(e_valid.sum()) + int(le_valid.sum())
        n_diff = int((e_card != cpu.e_inlier.numpy()).sum()) + int((le_card != cpu.le_inlier.numpy()).sum())
        log(f"{name} BA run {i}: card vs CPU on the same problem, keyframe poses {dt * 1e3:.4f} mm "
            f"{dr:.5f} deg, final cost {float(chi2_card):.4f} vs {chi2_cpu:.4f}, inlier edges differ "
            f"{n_diff} of {n_e}")
        if not (dt < 5e-3 and dr < 0.1 and abs(float(chi2_card) - chi2_cpu) <= 0.01 * chi2_cpu
                and n_diff <= 0.005 * n_e):
            raise AssertionError(f"{name} BA run {i}: the card's BA departs from the CPU's")


def check_triangulation(name, tracker, cfg, device) -> tuple:
    """Triangulation from one map state, on the card and on the CPU. The
    synthetic rooms give it nothing to do (depth already landmarks every
    keypoint), so a third of the map points and of the map lines the newest
    keyframe sees are erased from every keyframe first, as the slice test
    does to the JAX state (test_torch_full_tracker.py::test_f_*); their
    keypoints and segments are then candidates again. Gates: the card
    creates at least 20 points and 1 line, as many as the CPU (within
    2 %), the same map slots, positions within 1 mm of the CPU's; the
    re-created points lie within 5 % of their depth in the newest keyframe
    of the points they replace (median; two-view triangulation from
    keyframes a few cm apart, so not within the depth's own noise).
    Returns (points, lines) created on the card."""
    import copy

    from hfvo_tpu_torch.mapping.local_mapping import LocalMapper

    vm = copy.deepcopy(tracker.vomap)
    kf, kl = vm.keyframes, vm.kf_lines
    newest = vm.newest_kf_slot
    rng = np.random.default_rng(0)
    pid = kf.point_id[newest]
    seen = np.unique(pid[kf.obs_valid[newest] & (pid >= 0)])
    erased = seen[rng.uniform(size=len(seen)) < 1 / 3]
    lid = kl.line_id[newest]
    seen_l = np.unique(lid[kl.obs_valid[newest] & (lid >= 0)])
    erased_l = seen_l[rng.uniform(size=len(seen_l)) < 1 / 3]
    old_of_kp = np.where(np.isin(pid, erased), pid, -1)  # newest keyframe's kp -> erased point
    hit = np.isin(kf.point_id, erased)
    kf.point_id[hit], kf.obs_valid[hit] = -1, False
    vm.points.valid[erased] = False
    hit = np.isin(kl.line_id, erased_l)
    kl.line_id[hit], kl.obs_valid[hit] = -1, False
    vm.lines.valid[erased_l] = False

    made, maps = {}, {}
    for dev in (device, "cpu"):
        m = LocalMapper(cfg, copy.deepcopy(vm), dev)
        made[str(dev)] = (m.create_new_map_points(), m.create_new_map_lines())
        maps[str(dev)] = m.vomap
    (pc, lc), (pp, lp) = made[str(device)], made["cpu"]
    a, b = maps[str(device)], maps["cpu"]
    new_pts = a.points.valid & ~vm.points.valid
    gap_pts = np.abs(a.points.X_w - b.points.X_w)[a.points.valid & b.points.valid].max(initial=0.0)
    both_l = a.lines.valid & b.lines.valid
    gap_lines = max(np.abs(a.lines.X0_w - b.lines.X0_w)[both_l].max(initial=0.0),
                    np.abs(a.lines.X1_w - b.lines.X1_w)[both_l].max(initial=0.0))
    # Each re-created point against the point its keypoint in the newest
    # keyframe observed before the erasure.
    kp = np.nonzero(np.isin(a.keyframes.point_id[newest], np.nonzero(new_pts)[0]) & (old_of_kp >= 0))[0]
    T = a.keyframes.T_cw[newest]
    X_old = tracker.vomap.points.X_w[old_of_kp[kp]]
    to_old = np.linalg.norm(a.points.X_w[a.keyframes.point_id[newest][kp]] - X_old, axis=1)
    rel = to_old / (X_old @ T[:3, :3].T + T[:3, 3])[:, 2]
    med = float(np.median(rel)) if len(rel) else float("inf")
    log(f"{name} triangulation: {len(erased)} of {len(seen)} points and {len(erased_l)} of {len(seen_l)} lines of "
        f"the newest keyframe erased; created on the card {pc} points {lc} lines, on the CPU {pp} points "
        f"{lp} lines; card vs CPU positions within {gap_pts * 1e3:.4f} mm (points) {gap_lines * 1e3:.4f} mm "
        f"(lines); re-created points from the erased ones over their depth, median {med:.5f} p90 "
        f"{np.percentile(rel, 90) if len(rel) else float('inf'):.5f} ({len(rel)} points, median "
        f"{np.median(to_old) * 1e3 if len(rel) else float('inf'):.3f} mm)")
    if not (pc >= 20 and lc >= 1 and abs(pc - pp) <= 0.02 * pp and abs(lc - lp) <= 0.02 * lp
            and np.array_equal(a.points.valid, b.points.valid) and np.array_equal(a.lines.valid, b.lines.valid)
            and gap_pts < 1e-3 and gap_lines < 1e-3 and med < 0.05):
        raise AssertionError(f"{name}: triangulation on the card departs from the CPU's or from the erased points")
    return pc, lc


def run_system(device, cfg, grays, depths, n, use_local_ba=False):
    """Drive VOSystem.track_rgbd over the first `n` frames. Returns
    (system, results, per-frame wall seconds, per-frame dict of inlier line
    matches "lines", inlier full plane matches "planes" and "manh_valid",
    and the keyframe path's log "kf" (keyframe_path_log))."""
    from hfvo_tpu_torch.system import VOSystem

    system = VOSystem(cfg, device, use_local_ba=use_local_ba, use_loop_closing=False)
    results, secs, per = [], [], {"lines": [], "planes": [], "manh_valid": []}
    per["kf"] = keyframe_path_log(system.tracker)
    for i in range(n):
        t0 = time.perf_counter()
        results.append(system.track_rgbd(grays[i], depths[i], i / 30.0))
        secs.append(time.perf_counter() - t0)
        tr = system.tracker
        llo, plo = tr._last_line_out, tr._last_plane_out
        per["lines"].append(0 if llo is None else int((llo[2] >= 0).sum()))
        per["planes"].append(0 if plo is None else int((plo.seg.valid & (plo.kind == 0) & plo.inlier).sum()))
        per["manh_valid"].append(bool(tr.manh_valid))
    return system, results, secs, per


def pose_gap(Ta, Tb):
    """(metres, degrees) between two poses; the angle from the skew part of
    the relative rotation in float64, as the port's parity tests read it:
    the trace form of two float32 poses has a noise floor near 0.03 deg."""
    D = Ta.astype(np.float64) @ np.linalg.inv(Tb.astype(np.float64))
    R = D[:3, :3]
    sin = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    rot = np.degrees(np.arctan2(sin, 0.5 * (np.trace(R) - 1)))
    return float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])), float(rot)


def keyframe_share(name, results, tracked_ms) -> str:
    """Keyframe frames against the others, and their share of the frames at
    or above the p90 (frames 1..)."""
    kf = np.array([r.is_keyframe for r in results[1:]])
    p90 = np.percentile(tracked_ms, 90)
    top = tracked_ms >= p90
    med = lambda a: f"{np.median(a):.3f}" if len(a) else "-"  # noqa: E731
    return (f"{name}: keyframe frames {int(kf.sum())} median ms {med(tracked_ms[kf])}, other frames median "
            f"{med(tracked_ms[~kf])}; {int((top & kf).sum())} of the {int(top.sum())} frames at or above the "
            f"p90 ({p90:.3f} ms) are keyframe frames")


def run_path(name, device, cfg, frames, ate_gate, card, lines_ms=None, use_local_ba=False,
             jax_triangulated=None):
    """One path: its run with the launch counts reset just before and read
    just after, then its output checks (with local BA: the keyframe path's,
    against `jax_triangulated`). Returns (launches, median ms a tracked
    frame, p90); `lines_ms` is logged beside the full and default paths'."""
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.tracking.tracker import TrackState

    T_wc, grays, depths = frames
    reset_counts()
    system, results, secs, per = run_system(device, cfg, grays, depths, N_FRAMES, use_local_ba)
    n_lines, n_planes, manh = per["lines"], per["planes"], per["manh_valid"]
    torch.cuda.synchronize()
    launches = read_counts()
    # The initialization extracts one (H, W) frame (K1, K3); a tracked frame
    # runs the fused step at S = 1 on a (1, H, W) stack (K1b, K3b). One FAST
    # launch an extraction, for all its levels.
    stages = system.tracker.stage_times
    inits, steps = stages.get("init_extract", [0, 0])[1], stages.get("fused_step", [0, 0])[1]
    want = {"fast_score_dual": inits, "fast_score_dual_batched": steps,
            "fast_score": 0, "fast_score_batched": 0,
            "hough_vote": inits if cfg.use_lines else 0,
            "hough_vote_batched": steps if cfg.use_lines else 0}
    if launches != want or inits == 0 or steps == 0:
        raise AssertionError(f"{name}: launches {launches}, want {want} ({inits} inits, {steps} steps)")

    states = [r.state for r in results]
    n_lost = sum(s is not TrackState.OK for s in states)
    est = system.get_trajectory()
    if est.shape != (N_FRAMES, 4, 4) or not np.isfinite(est).all():
        raise AssertionError(f"{name}: trajectory of shape {est.shape}, finite {np.isfinite(est).all()}")
    ts = np.arange(N_FRAMES) / 30.0
    ate = evaluate.ate(ts, T_wc, ts, est, align="origin").rmse
    n_kf = sum(r.is_keyframe for r in results)
    tracked_ms = np.array(secs[1:]) * 1e3
    log(
        f"{name} path ({card}): {N_FRAMES} frames, LOST {n_lost}, keyframes {n_kf}, "
        f"ATE RMSE {ate:.6f} m, ms/tracked frame median {np.median(tracked_ms):.3f} "
        f"p90 {np.percentile(tracked_ms, 90):.3f} (init frame {secs[0] * 1e3:.3f} ms); "
        f"launches {launches}; inlier line matches frames 1-{N_FRAMES - 1}: {sum(n_lines[1:])} {n_lines}"
    )
    if cfg.use_planes:
        first = manh.index(True) if any(manh) else None
        log(f"{name} path: inlier full plane matches frames 1-{N_FRAMES - 1}: {sum(n_planes[1:])} {n_planes} "
            f"(JAX {JAX_FULL_PLANE_INLIERS}); Manhattan frame valid from frame {first} (JAX "
            f"{JAX_FULL_MANH_FIRST_FRAME}); map planes {int(system.tracker.vomap.planes.valid.sum())}; "
            f"ms/tracked frame median {np.median(tracked_ms):.3f} p90 {np.percentile(tracked_ms, 90):.3f} beside "
            f"the lines path's median {lines_ms:.3f} in this call")
    log(f"{name} stages: " + system.extract_times().replace("\n", "; "))
    if use_local_ba:
        log(ba_summary(name, [per["kf"]]))
    log(keyframe_share(name, results, tracked_ms))
    if n_lost:
        raise AssertionError(f"{name}: {n_lost} frames not tracked: {[s.name for s in states]}")
    if not ate <= ate_gate:
        raise AssertionError(f"{name}: ATE RMSE {ate} m above the {ate_gate} m gate")
    min_lines = MIN_LINE_INLIERS if not cfg.use_planes else int(np.ceil(0.75 * JAX_FULL_LINE_INLIERS))
    if cfg.use_lines and sum(n_lines[1:]) < min_lines:
        raise AssertionError(f"{name}: {sum(n_lines[1:])} inlier line matches, under {min_lines}")
    if cfg.use_planes:
        min_planes = int(np.ceil(0.75 * JAX_FULL_PLANE_INLIERS))
        if sum(n_planes[1:]) < min_planes:
            raise AssertionError(f"{name}: {sum(n_planes[1:])} inlier full plane matches, under {min_planes}")
        if first != JAX_FULL_MANH_FIRST_FRAME:
            raise AssertionError(f"{name}: Manhattan frame valid from frame {first}, the JAX run's from "
                                 f"{JAX_FULL_MANH_FIRST_FRAME}")
    if use_local_ba:
        check_triangulated(name, per["kf"], jax_triangulated)
        if per["kf"]["ba"]:
            check_ba(name, [per["kf"]], cfg.camera)
        check_triangulation(name, system.tracker, cfg, device)

    _, cpu_results, _, cpu_per = run_system("cpu", cfg, grays, depths, N_CPU_FRAMES, use_local_ba)
    cpu_lines = cpu_per["lines"]
    for i, (a, b) in enumerate(zip(results, cpu_results)):
        dt, dr = pose_gap(a.T_cw, b.T_cw)
        log(
            f"{name} frame {i}: card vs CPU {dt * 1e3:.4f} mm {dr:.5f} deg, matches "
            f"{a.n_matches} vs {b.n_matches}, line inliers {n_lines[i]} vs {cpu_lines[i]}"
        )
        if not (dt < CPU_GAP_M and dr < CPU_GAP_DEG) or a.is_keyframe != b.is_keyframe:
            raise AssertionError(f"{name} frame {i}: the card's run departs from the CPU run")
    return launches, float(np.median(tracked_ms)), float(np.percentile(tracked_ms, 90))


def run_low_texture(device, card):
    """The JAX suite's low-texture test on the card: the low-texture room
    (`make_room(0, low_texture=True)`, 20 orbit frames, rendered on the
    card), tracked by a points-only configuration and by `tum3_config()`,
    each on a fresh Tracker with local BA and loop closing off, started at
    the ground-truth pose of frame 0. The launch counts are reset just before
    the default configuration's run and read just after. Returns (launches,
    the BA logs)."""
    from hfvo_tpu_torch.config import tum3_config
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.testing import synthetic
    from hfvo_tpu_torch.tracking.tracker import Tracker, TrackState

    n = LOW_TEXTURE_FRAMES
    T_wc, grays, depths = synthetic.render_sequence(
        n=n, scene=synthetic.make_room(0, low_texture=True, device=device), device=device)
    c = tum3_config()
    ts = np.arange(n) / 30.0
    ates, logs = {}, {}
    for key, cfg in (("points_only", c.replace(use_lines=False, use_planes=False, use_manhattan=False)),
                     ("hybrid", c)):
        if key == "hybrid":
            reset_counts()
        tr = Tracker(cfg, device, use_local_ba=True, use_loop_closing=False)
        logs[key] = keyframe_path_log(tr)
        secs, results = [], []
        for i in range(n):
            t0 = time.perf_counter()
            results.append(tr.track_rgbd(grays[i], depths[i], T_cw_init=np.linalg.inv(T_wc[0])))
            secs.append(time.perf_counter() - t0)
        states = [r.state for r in results]
        torch.cuda.synchronize()
        est = tr.get_trajectory()
        if est.shape != (n, 4, 4) or not np.isfinite(est).all():
            raise AssertionError(f"low_texture {key}: trajectory of shape {est.shape}")
        ates[key] = float(evaluate.ate(ts, T_wc, ts, est, align="origin").rmse)
        tracked_ms = np.array(secs[1:]) * 1e3
        n_lost = sum(st is not TrackState.OK for st in states)
        log(f"low_texture {key} ({card}): {n} frames, LOST {n_lost}, keyframes {tr.vomap.kf_order_counter}, "
            f"ATE RMSE {ates[key]:.6f} m (JAX {JAX_LOW_TEXTURE_ATE_M[key]}), ms/tracked frame median "
            f"{np.median(tracked_ms):.3f} p90 {np.percentile(tracked_ms, 90):.3f}")
        log(ba_summary(f"low_texture {key}", [logs[key]]))
        log(keyframe_share(f"low_texture {key}", results, tracked_ms))
        if key == "hybrid":
            launches = read_counts()
            steps = tr.stage_times.get("fused_step", [0, 0])[1]
            want = {"fast_score_dual": 1, "fast_score_dual_batched": steps, "fast_score": 0,
                    "fast_score_batched": 0, "hough_vote": 1, "hough_vote_batched": steps}
            if launches != want or steps == 0:
                raise AssertionError(f"low_texture: launches {launches}, want {want}")
            log(f"low_texture hybrid stages: " + tr.stage_report().replace("\n", "; "))
    log(f"low_texture: hybrid ATE {ates['hybrid']:.6f} m against 0.6 x points-only "
        f"{0.6 * ates['points_only']:.6f} m and 0.05 m")
    if not (ates["hybrid"] < 0.6 * ates["points_only"] and ates["hybrid"] < 0.05):
        raise AssertionError(f"low_texture: hybrid ATE {ates['hybrid']} m, points-only {ates['points_only']} m")
    if len(logs["hybrid"]["ba_ms"]) < MIN_BA_RUNS:
        raise AssertionError(f"low_texture: local BA ran {len(logs['hybrid']['ba_ms'])} times")
    for key in ("points_only", "hybrid"):
        check_triangulated(f"low_texture {key}", logs[key], JAX_LOW_TEXTURE_TRIANGULATED[key])
    check_ba("low_texture points_only", [logs["points_only"]], c.camera, n_cpu=0)
    check_ba("low_texture hybrid", [logs["hybrid"]], c.camera)
    return launches, logs


def run_batch(device, cfg, seqs, n, seq_ids, use_local_ba=False):
    """Drive BatchTracker.track_batch over the first `n` frames of the
    sequences `seq_ids`, each initialized at its first frame with its
    ground-truth pose. Returns (tracker, results per frame, wall seconds per
    call, inlier line matches (frame, seq), inlier full plane matches
    (frame, seq), the keyframe-path logs per sequence)."""
    from hfvo_tpu_torch.parallel.multiseq import BatchTracker

    bt = BatchTracker(cfg, n_seq=len(seq_ids), device=device, use_local_ba=use_local_ba)
    logs = [keyframe_path_log(tr) for tr in bt.trackers]
    bt.warmup()
    results, secs, n_lines, n_planes = [], [], [], []
    for i in range(n):
        inits = [np.linalg.inv(seqs[s][0][0]) for s in seq_ids] if i == 0 else None
        t0 = time.perf_counter()
        results.append(bt.track_batch([seqs[s][1][i] for s in seq_ids],
                                      [seqs[s][2][i] for s in seq_ids], inits))
        secs.append(time.perf_counter() - t0)
        n_lines.append([0 if tr._last_line_out is None else int((tr._last_line_out[2] >= 0).sum())
                        for tr in bt.trackers])
        n_planes.append([0 if tr._last_plane_out is None else int(
            (tr._last_plane_out.seg.valid & (tr._last_plane_out.kind == 0) & tr._last_plane_out.inlier).sum())
            for tr in bt.trackers])
    return bt, results, secs, np.array(n_lines), np.array(n_planes), logs


def run_batch_path(name, device, cfg, seqs, card, single_ms, ref, use_local_ba=False):
    """A batch path: its run with the launch counts reset just before and
    read just after, then its output checks against `ref` (per sequence:
    "ate", and where given "lines", "planes" inlier matches and "ba_runs").
    Returns (launches, median ms a call, p90, frames/s, BA logs)."""
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.tracking.tracker import TrackState

    reset_counts()
    bt, results, secs, n_lines, n_planes, logs = run_batch(device, cfg, seqs, N_FRAMES, range(N_SEQ), use_local_ba)
    torch.cuda.synchronize()
    launches = read_counts()
    steps = N_FRAMES - 1
    want = {"fast_score_dual": N_SEQ, "fast_score_dual_batched": steps,
            "fast_score": 0, "fast_score_batched": 0,
            "hough_vote": N_SEQ, "hough_vote_batched": steps}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want}")

    batch_ms = np.array(secs[1:]) * 1e3
    fps = N_SEQ * steps / (batch_ms.sum() / 1e3)
    ts = np.arange(N_FRAMES) / 30.0
    log(
        f"{name} path ({card}): {N_SEQ} sequences x {N_FRAMES} frames; ms per batch over frames "
        f"1-{N_FRAMES - 1} median {np.median(batch_ms):.3f} p90 {np.percentile(batch_ms, 90):.3f} "
        f"(init batch {secs[0] * 1e3:.3f} ms); {fps:.3f} frames/s "
        f"across the {N_SEQ} sequences; single-sequence lines path {single_ms:.3f} ms a frame "
        f"({1e3 / single_ms:.3f} frames/s) in this call; launches {launches}"
    )
    if use_local_ba:
        log(ba_summary(name, logs))
    failed, plane_seqs = [], 0
    for s, (tr, est) in enumerate(zip(bt.trackers, bt.get_trajectories())):
        states = [r[s].state for r in results]
        n_lost = sum(st is not TrackState.OK for st in states)
        ate = float(evaluate.ate(ts, seqs[s][0], ts, est, align="origin").rmse) \
            if est.shape == (N_FRAMES, 4, 4) and np.isfinite(est).all() else float("nan")
        gate = min(1.5 * ref["ate"][s], 0.02)
        n_kf = sum(bool(r[s].is_keyframe) for r in results)
        msg = f"{name} seq {s}: LOST {n_lost}, keyframes {n_kf}, ATE RMSE {ate:.6f} m (gate {gate:.6f})"
        bad = bool(n_lost) or not ate <= gate
        for key, got in (("lines", n_lines), ("planes", n_planes)):
            if key in ref:
                min_in = int(np.ceil(0.75 * ref[key][s]))
                n_in = int(got[1:, s].sum())
                if key == "planes":
                    plane_seqs += n_in >= min_in
                    min_in = min(min_in, steps)  # the first wall in every tracked frame
                msg += f", inlier {key[:-1]} matches frames 1-{N_FRAMES - 1} {n_in} (gate {min_in})"
                bad |= n_in < min_in
        if "ba_runs" in ref:
            n_ba = len(logs[s]["ba_ms"])
            msg += f", local BA runs {n_ba} (JAX {ref['ba_runs'][s]}, gate {MIN_BA_RUNS})"
            bad |= n_ba < MIN_BA_RUNS
        log(msg)
        if bad:
            failed.append(s)
    if "planes" in ref:
        total, min_total = int(n_planes[1:].sum()), int(np.ceil(0.75 * sum(ref["planes"])))
        log(f"{name}: inlier plane matches of the {N_SEQ} sequences {total} (gate {min_total}, JAX "
            f"{sum(ref['planes'])}); {plane_seqs} sequences reach 75 % of JAX's count (gate {MIN_PLANE_SEQS})")
        if total < min_total or plane_seqs < MIN_PLANE_SEQS:
            failed.append("all")
    if failed:
        raise AssertionError(f"{name}: sequences {failed} fail their gates")
    if use_local_ba:
        check_ba(name, logs, cfg.camera)

    _, cpu_results, _, cpu_lines, _, _ = run_batch("cpu", cfg, seqs, N_CPU_FRAMES, CPU_BATCH_SEQS, use_local_ba)
    for i in range(N_CPU_FRAMES):
        for j, s in enumerate(CPU_BATCH_SEQS):
            a, b = results[i][s], cpu_results[i][j]
            dt, dr = pose_gap(a.T_cw, b.T_cw)
            log(f"{name} frame {i} seq {s}: card (batch of {N_SEQ}) vs CPU (batch of "
                f"{len(CPU_BATCH_SEQS)}) {dt * 1e3:.4f} mm {dr:.5f} deg, matches {a.n_matches} vs "
                f"{b.n_matches}, line inliers {n_lines[i, s]} vs {cpu_lines[i, j]}")
            if not (dt < CPU_GAP_M and dr < CPU_GAP_DEG) or a.is_keyframe != b.is_keyframe:
                raise AssertionError(f"{name} frame {i} seq {s}: the card's run departs from the CPU run")
    return launches, float(np.median(batch_ms)), float(np.percentile(batch_ms, 90)), fps, logs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    import hfvo_tpu_torch  # noqa: F401  (fp32 policy)
    from hfvo_tpu_torch.config import full_step, points_and_lines, points_only, tum3_config
    from hfvo_tpu_torch.ops import _kernels
    from hfvo_tpu_torch.testing import synthetic

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 1. Build every kernel from the checkout's sources, in parallel.
    t0 = time.perf_counter()
    names = _kernels.names()
    built = _kernels.build_all(names)
    log(f"built kernels {names} in {time.perf_counter() - t0:.3f} s")
    for name in names:
        info = [ln.strip() for ln in built[name].splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: {' | '.join(info) or built[name].strip()}")
    if "spill stores" not in built["hough_vote"] or _kernels.spill_bytes(built["hough_vote"]):
        raise AssertionError(f"hough_vote: ptxas reports spills or no spill line: {built['hough_vote']}")

    cfg_points = points_only(tum3_config())
    cfg_lines = points_and_lines(tum3_config())
    cfg_full = full_step(tum3_config())
    c = cfg_lines.cap
    log(
        f"config: tum3, n_features {cfg_lines.orb.n_features}, {cfg_lines.orb.n_levels} levels, "
        f"cap.keypoints {c.keypoints}, cap.local_points {c.local_points}, cap.map_points {c.map_points}; "
        f"lines path: cap.lines {c.lines}, cap.local_lines {c.local_lines}, cap.map_lines {c.map_lines}, "
        f"lk_recovery {cfg_lines.lines.lk_recovery}; full path: cap.planes {cfg_full.cap.planes}, "
        f"cap.map_planes {cfg_full.cap.map_planes}, use_lines {cfg_full.use_lines}, use_planes "
        f"{cfg_full.use_planes}, use_manhattan {cfg_full.use_manhattan}"
    )

    t0 = time.perf_counter()
    seqs = [synthetic.render_sequence(n=N_FRAMES, seed=s, device=device) for s in range(N_SEQ)]
    frames = seqs[0]
    log(f"rendered {N_SEQ} x {N_FRAMES} frames of 640x480 on the card in {time.perf_counter() - t0:.3f} s")
    # Frame 1 of each sequence, uint8-truncated as tracked frames are.
    stack = torch.stack([_tracked_gray(device, q[1][1]) for q in seqs])

    # 2. Kernels against their plain versions.
    cycles_per_ms = _sleep_cycles_per_ms()
    rows = check_fast(device, cfg_points, cycles_per_ms, frames[1][0], stack)
    rows.update(check_hough(device, cycles_per_ms, frames[1][0], stack))

    # 3-9. The paths, each with its own launch counts.
    paths = {}
    paths["points"], _, _ = run_path("points", device, cfg_points, frames, ATE_GATE_POINTS_M, card)
    paths["lines"], lines_ms, _ = run_path("lines", device, cfg_lines, frames, ATE_GATE_LINES_M, card)
    paths["full"], full_ms, full_p90 = run_path("full", device, cfg_full, frames, 1.5 * JAX_FULL_ATE_M,
                                                card, lines_ms)
    paths["default"], default_ms, default_p90 = run_path(
        "default", device, tum3_config(), frames, min(1.5 * JAX_DEFAULT_ATE_M, 0.02), card, lines_ms,
        use_local_ba=True, jax_triangulated=JAX_DEFAULT_TRIANGULATED)
    log(f"default path: ms/tracked frame median {default_ms:.3f} p90 {default_p90:.3f} beside the full "
        f"path's median {full_ms:.3f} p90 {full_p90:.3f} in this call")
    paths["low_texture"], _ = run_low_texture(device, card)
    paths["batch"], *_ = run_batch_path("batch", device, cfg_lines, seqs, card, lines_ms,
                                        {"ate": JAX_BATCH_ATE_M, "lines": JAX_BATCH_LINE_INLIERS})
    paths["batch_full"], *_ = run_batch_path(
        "batch_full", device, tum3_config(), seqs, card, lines_ms,
        {"ate": JAX_BATCH_FULL_ATE_M, "lines": JAX_BATCH_FULL_LINE_INLIERS, "planes": JAX_BATCH_FULL_PLANE_INLIERS})
    paths["batch_ba"], *_ = run_batch_path(
        "batch_ba", device, tum3_config(), seqs, card, lines_ms,
        {"ate": JAX_BATCH_BA_ATE_M, "ba_runs": JAX_BATCH_BA_RUNS}, use_local_ba=True)
    for name, row in rows.items():
        by_path = row.setdefault("launches_by_path", {})
        by_path.update({path: counts[name] for path, counts in paths.items()})
        # `launches` counts the main path, the JAX package's default system.
        # K2 and K2b are on no tracking path: theirs are those of their own
        # entry point's run (check_fast).
        row["launches_path"] = "pyramid_fast_scores" if name in ("fast_score", "fast_score_batched") else "default"
        row["launches"] = by_path[row["launches_path"]]

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": [rows[k] for k in KERNELS]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
