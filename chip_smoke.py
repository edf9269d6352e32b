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
6. The batch path: `BatchTracker.track_batch` of 8 point + line sequences
   (orbits of seeds 0-7) over 25 frames at 640x480.
   For each path the launch counts are set to 0 just before its run and
   read just after; every kernel of the path must have launched in it, once
   per call of its function (FAST: once an extraction, for all levels).
7. Output checks, per path: no LOST frame, finite poses, ATE RMSE within the
   gate, the first frames agree with the same system run on the CPU (where
   every wrapper takes its plain version), with the same keyframes; on the
   lines, full and batch paths, enough inlier line matches; on the full
   path, the Manhattan frame valid from the JAX run's frame and enough
   inlier full plane matches.

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


def run_system(device, cfg, grays, depths, n):
    """Drive VOSystem.track_rgbd over the first `n` frames. Returns
    (system, results, per-frame wall seconds, per-frame dict of inlier line
    matches "lines", inlier full plane matches "planes" and "manh_valid")."""
    from hfvo_tpu_torch.system import VOSystem

    system = VOSystem(cfg, device, use_local_ba=False, use_loop_closing=False)
    results, secs, per = [], [], {"lines": [], "planes": [], "manh_valid": []}
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
    D = Ta @ np.linalg.inv(Tb)
    rot = np.degrees(np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)))
    return float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])), float(rot)


def run_path(name, device, cfg, frames, ate_gate, card, lines_ms=None):
    """One path: its run with the launch counts reset just before and read
    just after, then its output checks. Returns (launches, median ms a
    tracked frame); `lines_ms` is logged beside the full path's."""
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.tracking.tracker import TrackState

    T_wc, grays, depths = frames
    reset_counts()
    system, results, secs, per = run_system(device, cfg, grays, depths, N_FRAMES)
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

    _, cpu_results, _, cpu_per = run_system("cpu", cfg, grays, depths, N_CPU_FRAMES)
    cpu_lines = cpu_per["lines"]
    for i, (a, b) in enumerate(zip(results, cpu_results)):
        dt, dr = pose_gap(a.T_cw, b.T_cw)
        log(
            f"{name} frame {i}: card vs CPU {dt * 1e3:.4f} mm {dr:.5f} deg, matches "
            f"{a.n_matches} vs {b.n_matches}, line inliers {n_lines[i]} vs {cpu_lines[i]}"
        )
        if not (dt < CPU_GAP_M and dr < CPU_GAP_DEG) or a.is_keyframe != b.is_keyframe:
            raise AssertionError(f"{name} frame {i}: the card's run departs from the CPU run")
    return launches, float(np.median(tracked_ms))


def run_batch(device, cfg, seqs, n, seq_ids):
    """Drive BatchTracker.track_batch over the first `n` frames of the
    sequences `seq_ids`, each initialized at its first frame with its
    ground-truth pose. Returns (tracker, results per frame, wall seconds per
    call, inlier line matches (frame, seq))."""
    from hfvo_tpu_torch.parallel.multiseq import BatchTracker

    bt = BatchTracker(cfg, n_seq=len(seq_ids), device=device, use_local_ba=False)
    bt.warmup()
    results, secs, n_lines = [], [], []
    for i in range(n):
        inits = [np.linalg.inv(seqs[s][0][0]) for s in seq_ids] if i == 0 else None
        t0 = time.perf_counter()
        results.append(bt.track_batch([seqs[s][1][i] for s in seq_ids],
                                      [seqs[s][2][i] for s in seq_ids], inits))
        secs.append(time.perf_counter() - t0)
        n_lines.append([0 if tr._last_line_out is None else int((tr._last_line_out[2] >= 0).sum())
                        for tr in bt.trackers])
    return bt, results, secs, np.array(n_lines)


def run_batch_path(device, cfg, seqs, card, single_ms):
    """The batch path: its run with the launch counts reset just before and
    read just after, then its output checks. Returns its launches."""
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.tracking.tracker import TrackState

    reset_counts()
    bt, results, secs, n_lines = run_batch(device, cfg, seqs, N_FRAMES, range(N_SEQ))
    torch.cuda.synchronize()
    launches = read_counts()
    steps = N_FRAMES - 1
    want = {"fast_score_dual": N_SEQ, "fast_score_dual_batched": steps,
            "fast_score": 0, "fast_score_batched": 0,
            "hough_vote": N_SEQ, "hough_vote_batched": steps}
    if launches != want:
        raise AssertionError(f"batch: launches {launches}, want {want}")

    batch_ms = np.array(secs[1:]) * 1e3
    ts = np.arange(N_FRAMES) / 30.0
    log(
        f"batch path ({card}): {N_SEQ} sequences x {N_FRAMES} frames; ms per batch over frames "
        f"1-{N_FRAMES - 1} median {np.median(batch_ms):.3f} p90 {np.percentile(batch_ms, 90):.3f} "
        f"(init batch {secs[0] * 1e3:.3f} ms); {N_SEQ * steps / (batch_ms.sum() / 1e3):.3f} frames/s "
        f"across the {N_SEQ} sequences; single-sequence lines path {single_ms:.3f} ms a frame "
        f"({1e3 / single_ms:.3f} frames/s) in this call; launches {launches}"
    )
    for s, (tr, est) in enumerate(zip(bt.trackers, bt.get_trajectories())):
        states = [r[s].state for r in results]
        n_lost = sum(st is not TrackState.OK for st in states)
        ate = float(evaluate.ate(ts, seqs[s][0], ts, est, align="origin").rmse) \
            if est.shape == (N_FRAMES, 4, 4) and np.isfinite(est).all() else float("nan")
        gate = min(1.5 * JAX_BATCH_ATE_M[s], 0.02)
        n_in, min_in = int(n_lines[1:, s].sum()), int(np.ceil(0.75 * JAX_BATCH_LINE_INLIERS[s]))
        n_kf = sum(bool(r[s].is_keyframe) for r in results)
        log(f"batch seq {s}: LOST {n_lost}, keyframes {n_kf}, ATE RMSE {ate:.6f} m (gate {gate:.6f}), "
            f"inlier line matches frames 1-{N_FRAMES - 1} {n_in} (gate {min_in})")
        if n_lost or not ate <= gate or n_in < min_in:
            raise AssertionError(f"batch seq {s}: LOST {n_lost}, ATE {ate}, line inliers {n_in}")

    _, cpu_results, _, cpu_lines = run_batch("cpu", cfg, seqs, N_CPU_FRAMES, CPU_BATCH_SEQS)
    for i in range(N_CPU_FRAMES):
        for j, s in enumerate(CPU_BATCH_SEQS):
            a, b = results[i][s], cpu_results[i][j]
            dt, dr = pose_gap(a.T_cw, b.T_cw)
            log(f"batch frame {i} seq {s}: card (batch of {N_SEQ}) vs CPU (batch of "
                f"{len(CPU_BATCH_SEQS)}) {dt * 1e3:.4f} mm {dr:.5f} deg, matches {a.n_matches} vs "
                f"{b.n_matches}, line inliers {n_lines[i, s]} vs {cpu_lines[i, j]}")
            if not (dt < CPU_GAP_M and dr < CPU_GAP_DEG) or a.is_keyframe != b.is_keyframe:
                raise AssertionError(f"batch frame {i} seq {s}: the card's run departs from the CPU run")
    return launches


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

    # 3-7. The four paths, each with its own launch counts.
    points, _ = run_path("points", device, cfg_points, frames, ATE_GATE_POINTS_M, card)
    lines_, lines_ms = run_path("lines", device, cfg_lines, frames, ATE_GATE_LINES_M, card)
    full, _ = run_path("full", device, cfg_full, frames, 1.5 * JAX_FULL_ATE_M, card, lines_ms)
    batch = run_batch_path(device, cfg_lines, seqs, card, lines_ms)
    for name, row in rows.items():
        by_path = row.setdefault("launches_by_path", {})
        by_path.update({"points": points[name], "lines": lines_[name], "full": full[name],
                        "batch": batch[name]})
        # `launches` counts the main path, the full tracking step. K2 and K2b
        # are on no tracking path: theirs are those of their own entry
        # point's run (check_fast).
        row["launches_path"] = "pyramid_fast_scores" if name in ("fast_score", "fast_score_batched") else "full"
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
