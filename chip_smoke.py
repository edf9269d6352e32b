#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`hfvo_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It imports only `hfvo_tpu_torch`, torch and numpy, and needs no JAX, no
dataset and no network: frames come from the port's synthetic renderer.

1. Setup: the card's name and power limit, the torch and CUDA versions, and
   the build of every kernel of the paths from `hfvo_tpu_torch/csrc/` (one
   nvcc per source, all started together).
2. Kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, timed with CUDA events, beside its bound
   (the larger of its bytes over 3.35 TB/s and its operations over the
   card's float32 peak) and, where one PyTorch call computes the same
   function, that call's time.
3. The points path: points-only `VOSystem.track_rgbd` over the renderer's
   25-frame orbit at 640x480.
4. The lines path: point + line `VOSystem.track_rgbd` over the same frames.
   For each path the launch counts are set to 0 just before its run and
   read just after; every kernel of the path must have launched in it, once
   per call of its function.
5. Output checks, per path: no LOST frame, finite poses, ATE RMSE within the
   gate, the first frames agree with the same system run on the CPU (where
   every wrapper takes its plain version); on the lines path, enough inlier
   line matches.

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


def check_fast_dual(device, cfg, cycles_per_ms, gray_np):
    """K1 against its plain version at the main path's shapes: the pyramid
    levels of a rendered 480x640 frame (uint8-truncated, as tracked frames
    are), and 250x330 uniform noise (seed 7). Returns the kernel's table row
    without `launches`."""
    from hfvo_tpu_torch.ops import fast, image

    levels = image.build_pyramid(_tracked_gray(device, gray_np), cfg.orb.n_levels, cfg.orb.scale_factor)
    noise = np.random.default_rng(7).uniform(0, 255, (250, 330)).astype(np.float32)
    imgs = [("level%d" % i, lvl.contiguous()) for i, lvl in enumerate(levels)]
    imgs.append(("noise", torch.from_numpy(noise).to(device)))
    lo, hi = float(cfg.orb.min_th_fast), float(cfg.orb.ini_th_fast)

    max_err, ms_sum, plain_sum, pixels = 0.0, 0.0, 0.0, 0
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
            pixels += img.numel()
        log(
            f"fast_score_dual {name} {tuple(img.shape)}: corners {int((got > 0).sum())}, "
            f"max_abs_err {err:.3g}; device ms kernel {k_dev:.5f} plain {p_dev:.5f}; "
            f"call ms kernel {k_call:.5f} plain {p_call:.5f}"
        )
    # Bytes: each pixel read once and its score written once (8 B). Work:
    # 2 thresholds x 16 ring pixels x (2 compares, ~2 adds) plus the arc test.
    bound_ms, bound_by = bound(8.0 * pixels, 2 * 16 * 4.0 * pixels)
    return {
        "name": "fast_score_dual",
        "route": "cuda",
        "source": "hfvo_tpu_torch/csrc/fast_dual.cu",
        "replaces": "hfvo_tpu/ops/pallas_fast.py:84",
        "max_abs_err": max_err,
        "ms": ms_sum,
        "plain_ms": plain_sum,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "ms_is": f"device time per extraction: sum over the {len(levels)} pyramid levels of 480x640",
    }


def check_hough_vote(device, cycles_per_ms, gray_np):
    """K3 against its plain version at the main path's shapes: the 70 tiles
    of a rendered 480x640 frame (its Sobel magnitude and angle, as
    detect_lines computes them) and the 15 tiles of 250x330 uniform noise
    (seed 7). Returns the kernel's table row without `launches`."""
    from hfvo_tpu_torch.ops import image, lines

    noise = np.random.default_rng(7).uniform(0, 255, (250, 330)).astype(np.float32)
    max_rel, max_abs, row = 0.0, 0.0, None
    for name, img in (("frame", _tracked_gray(device, gray_np)),
                      ("noise", torch.from_numpy(noise).to(device))):
        gx, gy = image.sobel_gradients(img)
        mag = torch.sqrt(gx * gx + gy * gy).contiguous()
        ang = torch.remainder(torch.atan2(gy, gx), torch.pi).contiguous()
        got = lines.hough_vote(mag, ang, 12.0)
        want = lines.hough_vote_reference(mag, ang, 12.0)
        torch.cuda.synchronize()
        rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
        if not rel <= K3_RTOL:
            raise AssertionError(f"hough_vote {name}: max relative err {rel}")
        g, w = got.reshape(got.shape[0], -1).cpu().numpy(), want.reshape(got.shape[0], -1).cpu().numpy()
        n_checked = 0
        for k in range(w.shape[0]):
            srt = np.sort(w[k])[::-1]
            if srt[3] - srt[4] > K3_RTOL * max(abs(srt[3]), 1.0):
                n_checked += 1
                if set(np.argsort(w[k])[-4:]) != set(np.argsort(g[k])[-4:]):
                    raise AssertionError(f"hough_vote {name}: tile {k} top-4 bins differ")
        max_rel = max(max_rel, rel)
        max_abs = max(max_abs, float((got - want).abs().max()))
        k_dev, k_call = device_ms(lambda: lines.hough_vote(mag, ang, 12.0), cycles_per_ms)
        p_dev, p_call = device_ms(lambda: lines.hough_vote_reference(mag, ang, 12.0), cycles_per_ms)
        # Yardstick: one bincount over the precomputed flat bins and weights
        # of all votes (it leaves out the bin computation itself).
        idx, wts = _flat_votes(mag, ang)
        n_bins = got.numel()
        l_dev, _ = device_ms(lambda: torch.bincount(idx, weights=wts, minlength=n_bins), cycles_per_ms)
        T = got.shape[0]
        tiled_px = T * lines.TILE * lines.TILE
        n_votes = int(idx.numel())
        # Bytes: mag and angle over the tiled region (8 B a pixel) and the
        # accumulators written once. Work: ~3 operations a pixel for its
        # theta bin, ~8 a vote for rho, its bin and the add.
        b_ms, b_by = bound(8.0 * tiled_px + 4.0 * n_bins, 3.0 * tiled_px + 8.0 * n_votes)
        log(
            f"hough_vote {name} {tuple(img.shape)}: {T} tiles, {n_votes} votes, "
            f"max_rel_err {rel:.3g}, top-4 checked in {n_checked} tiles; device ms kernel {k_dev:.5f} "
            f"plain {p_dev:.5f} bincount {l_dev:.5f} (bins precomputed, not timed); "
            f"call ms kernel {k_call:.5f} plain {p_call:.5f}; bound ms {b_ms:.6f} ({b_by})"
        )
        if name == "frame":
            row = {
                "name": "hough_vote",
                "route": "cuda",
                "source": "hfvo_tpu_torch/csrc/hough_vote.cu",
                "replaces": "hfvo_tpu/ops/pallas_hough.py:45",
                "ms": k_dev,
                "plain_ms": p_dev,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": l_dev,
                "ms_is": "device time per detect_lines call (70 tiles of 480x640); library_ms is "
                         "torch.bincount on precomputed bins, without the bin computation",
            }
    row["max_abs_err"] = max_abs
    row["max_rel_err"] = max_rel  # |kernel - plain| / max(|plain|, 1)
    return row


def _flat_votes(mag, ang):
    """(flat bin index, weight) of every vote of the plain version."""
    from hfvo_tpu_torch.ops import lines

    m_t, na_t = lines.to_tiles(mag), lines.to_tiles(ang)
    table = lines._table_on(str(mag.device))
    xl, yl = lines._local_xy(mag.device)
    tb = lines._theta_bin(na_t)
    tile = torch.arange(m_t.shape[0], device=mag.device)[:, None] * (lines.N_THETA * lines.N_RHO)
    on = m_t > 12.0
    idx, wts = [], []
    for delta, scale in ((0, 1.0), (-1, 0.5), (1, 0.5)):
        t = torch.remainder(tb + delta, lines.N_THETA)
        rb = lines._rho_bin(xl * table[0][t] + yl * table[1][t])
        idx.append((tile + t * lines.N_RHO + rb)[on])
        wts.append((m_t * scale)[on])
    return torch.cat(idx), torch.cat(wts)


def run_system(device, cfg, grays, depths, n):
    """Drive VOSystem.track_rgbd over the first `n` frames. Returns
    (system, results, per-frame wall seconds, inlier line matches a frame)."""
    from hfvo_tpu_torch.system import VOSystem

    system = VOSystem(cfg, device, use_local_ba=False, use_loop_closing=False)
    results, secs, n_lines = [], [], []
    for i in range(n):
        t0 = time.perf_counter()
        results.append(system.track_rgbd(grays[i], depths[i], i / 30.0))
        secs.append(time.perf_counter() - t0)
        llo = system.tracker._last_line_out
        n_lines.append(0 if llo is None else int((llo[2] >= 0).sum()))
    return system, results, secs, n_lines


def pose_gap(Ta, Tb):
    D = Ta @ np.linalg.inv(Tb)
    rot = np.degrees(np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)))
    return float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])), float(rot)


def run_path(name, device, cfg, frames, ate_gate, card):
    """One path: its run with the launch counts reset just before and read
    just after, then its output checks. Returns (launches, system,
    inlier line matches a frame)."""
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.ops import fast, lines
    from hfvo_tpu_torch.tracking.tracker import TrackState

    T_wc, grays, depths = frames
    fast.fast_dual_launches = 0
    lines.hough_vote_launches = 0
    system, results, secs, n_lines = run_system(device, cfg, grays, depths, N_FRAMES)
    torch.cuda.synchronize()
    launches = {"fast_score_dual": fast.fast_dual_launches, "hough_vote": lines.hough_vote_launches}
    stages = system.tracker.stage_times
    extractions = stages.get("init_extract", [0, 0])[1] + stages.get("fused_step", [0, 0])[1]
    detections = stages.get("init_lines", [0, 0])[1] + stages.get("fused_step", [0, 0])[1]
    if launches["fast_score_dual"] == 0 or launches["fast_score_dual"] != cfg.orb.n_levels * extractions:
        raise AssertionError(
            f"{name}: fast_score_dual launched {launches['fast_score_dual']} times for "
            f"{extractions} extractions of {cfg.orb.n_levels} levels"
        )
    want_k3 = detections if cfg.use_lines else 0
    if launches["hough_vote"] != want_k3 or (cfg.use_lines and want_k3 == 0):
        raise AssertionError(
            f"{name}: hough_vote launched {launches['hough_vote']} times for {want_k3} detect_lines calls"
        )

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
    log(f"{name} stages: " + system.extract_times().replace("\n", "; "))
    if n_lost:
        raise AssertionError(f"{name}: {n_lost} frames not tracked: {[s.name for s in states]}")
    if not ate <= ate_gate:
        raise AssertionError(f"{name}: ATE RMSE {ate} m above the {ate_gate} m gate")
    if cfg.use_lines and sum(n_lines[1:]) < MIN_LINE_INLIERS:
        raise AssertionError(f"{name}: {sum(n_lines[1:])} inlier line matches, under {MIN_LINE_INLIERS}")

    _, cpu_results, _, cpu_lines = run_system("cpu", cfg, grays, depths, N_CPU_FRAMES)
    for i, (a, b) in enumerate(zip(results, cpu_results)):
        dt, dr = pose_gap(a.T_cw, b.T_cw)
        log(
            f"{name} frame {i}: card vs CPU {dt * 1e3:.4f} mm {dr:.5f} deg, matches "
            f"{a.n_matches} vs {b.n_matches}, line inliers {n_lines[i]} vs {cpu_lines[i]}"
        )
        if not (dt < CPU_GAP_M and dr < CPU_GAP_DEG) or a.is_keyframe != b.is_keyframe:
            raise AssertionError(f"{name} frame {i}: the card's run departs from the CPU run")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    import hfvo_tpu_torch  # noqa: F401  (fp32 policy)
    from hfvo_tpu_torch.config import points_and_lines, points_only, tum3_config
    from hfvo_tpu_torch.ops import _kernels
    from hfvo_tpu_torch.testing import synthetic

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 1. Build every kernel from the checkout's sources, in parallel.
    t0 = time.perf_counter()
    names = ["fast_dual", "hough_vote"]
    built = _kernels.build_all(names)
    log(f"built kernels {names} in {time.perf_counter() - t0:.3f} s")
    for name in names:
        info = [ln.strip() for ln in built[name].splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: {' | '.join(info) or built[name].strip()}")

    cfg_points = points_only(tum3_config())
    cfg_lines = points_and_lines(tum3_config())
    c = cfg_lines.cap
    log(
        f"config: tum3, n_features {cfg_lines.orb.n_features}, {cfg_lines.orb.n_levels} levels, "
        f"cap.keypoints {c.keypoints}, cap.local_points {c.local_points}, cap.map_points {c.map_points}; "
        f"lines path: cap.lines {c.lines}, cap.local_lines {c.local_lines}, cap.map_lines {c.map_lines}, "
        f"lk_recovery {cfg_lines.lines.lk_recovery}"
    )

    t0 = time.perf_counter()
    frames = synthetic.render_sequence(n=N_FRAMES, seed=0, device=device)
    log(f"rendered {N_FRAMES} frames of 640x480 on the card in {time.perf_counter() - t0:.3f} s")

    # 2. Kernels against their plain versions.
    cycles_per_ms = _sleep_cycles_per_ms()
    k1 = check_fast_dual(device, cfg_points, cycles_per_ms, frames[1][0])
    k3 = check_hough_vote(device, cycles_per_ms, frames[1][0])

    # 3-5. The two paths, each with its own launch counts.
    points = run_path("points", device, cfg_points, frames, ATE_GATE_POINTS_M, card)
    lines_ = run_path("lines", device, cfg_lines, frames, ATE_GATE_LINES_M, card)
    for row in (k1, k3):
        row["launches"] = lines_[row["name"]]
        row["launches_by_path"] = {"points": points[row["name"]], "lines": lines_[row["name"]]}

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": [k1, k3]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
