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
   refusals checked to launch nothing. The pose LM's kernel
   (`csrc/pose_lm.cu`, one launch a pose_optimization call) on the inputs
   the fused step gave it on the 10th frame of a default-config VOSystem
   (S = 1) and of an 8-sequence BatchTracker (S = 8), against the plain
   version, timed at the wrapper's 512 threads a block and, as an ablation,
   at 128, 256 and 512;
   a traced run of those frames counts one `lm_kernel` a fused step and no
   host convergence test (`lm_test`). Every tracking path and batch path
   below counts one LM launch a fused step.
3. The points path: points-only `VOSystem.track_rgbd` over the renderer's
   25-frame orbit at 640x480.
4. The lines path: point + line `VOSystem.track_rgbd` over the same frames.
5. The full path, the main path of the system: `VOSystem.track_rgbd` with
   the JAX package's default tracking step (lines, planes and Manhattan
   axes; `config.full_step`) over the same frames, at every width of tum3
   (cap.planes 32).
6. The default path, the JAX package's default system: `VOSystem(
   tum3_config())` with every default (the full step plus the keyframe
   path: point and line triangulation, local BA, loop closing, the
   early-loss reset) over the same frames; the points and lines it
   triangulates a keyframe, its local BA runs and their ms.
7. The low-texture room of the JAX suite's `test_low_texture.py` (20 orbit
   frames), tracked by a points-only and by the default configuration,
   each on a fresh `Tracker` with its defaults; local BA's runs and ms.
8. Relocalization (run_reloc), the JAX suite's protocols at 640x480: the
   kidnapped camera (`tests/test_reloc.py`: 8 frames, 2 blank frames with
   zero depth, then frame 1), the depth-free PnP branch
   (`tests/test_reloc_pnp.py`) and a textureless frame with the `Tracker`
   defaults (`tests/test_tracker.py`); each relocalization's branch and ms.
9. Loop closing (run_loop) on the synthetic loop map
   (`hfvo_tpu_torch.testing.loop_map`): `LoopCloser.detect_and_close` on
   the card and on the CPU from one state with the same RANSAC samples;
   a global BA (check_gba) on the map of `tests/test_global_ba.py`,
   tracked on the card, and on the low-texture room's final map, each
   perturbed as that test perturbs its map, on the card and on the CPU,
   the low-texture one also in float64 and with its edges in another
   order (check_gba_conditioning); the ms, device ops and idle share of a
   closure, a pose graph and a global BA.
10. The batch paths, `BatchTracker.track_batch` of 8 sequences (orbits of
   seeds 0-7) over 25 frames at 640x480: point + line tracking; the full
   step (`tum3_config()`, the JAX benchmark's batch configuration); the
   full step with local BA after each keyframe; and a batch of 2 (orbits
   0 and 1, `BatchTracker(tum3_config(), 2)`, rendered on the CPU as its
   JAX reference is) whose sequence 1 gets two blank frames and goes LOST
   inside the batch (batch_lost).
   For each path the launch counts are set to 0 just before its run and
   read just after; every kernel of the path must have launched in it, once
   per call of its function (FAST: once an extraction, for all levels).
11. Output checks, per path: no LOST frame, finite poses, ATE RMSE within the
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
   of the low-texture room and of the batch, and every run of batch_lost's
   sequence 1, solved again on the CPU from the captured problem
   (check_ba). Relocalization, loop closing, the
   global BA and batch_lost: the gates of the JAX tests they follow, and
   card against CPU.
12. The JAX package's functions that no path calls (run_leftovers):
   `pyr_lk` and `recover_line_by_flow` on tests/test_lk.py's protocols,
   `binarize_band_desc` and `inv6x6_blocked`, each against the CPU, with
   their ms.
13. The distributed layer (run_distributed; `hfvo_tpu_torch/parallel/`):
   (a) a 1-rank NCCL group in this process: `BatchTracker(tum3_config(),
   8)` with a 1-rank mesh over 10 frames of the batch orbits against
   batch_full, and the low-texture room with `LocalMapper(
   use_distributed=True)`, every BA run the single-device solve; (b) two spawned
   ranks on this GPU over gloo: the JAX package's five-path dry run at
   n = 2 (distributed local BA, the seq + edge pose LM, global BA, pose
   graph, the sharded BoW database) with its gates, the sharded batch of
   the 8 orbits (4 a rank, K1b and K3b launched on each), and the
   low-texture room's captured local BA problems solved over the ranks
   against their single-device card solves; every replicated output
   bit-equal on the two ranks.
14. The JAX suite's robustness protocols (run_adversarial, after
   leftovers): tests/test_adversarial.py's five scenes (slanted quads and
   spheres, tum1 lens distortion, noisy depth with holes, low-texture
   slanted, the ICL preset's negative fy), tests/test_depth_stride.py's
   strides 1 and 4 and the Hough recall of tests/test_parity_deviations.py,
   each with its test's gates, its ATE within 1.5x the JAX package's on
   the same renders, and its launch counts.

Any failed phase raises, and the script exits non-zero without the final
line. It prints the kernel table as one JSON line, then the card's
`nvidia-smi` name and power limit, then as the last line
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import inspect
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
# Default path (the JAX package's default system, loop closing on): the
# same run on the CPU, `full_reference_jax.py --config default`: ATE
# 0.00700598 m on the orbit (3 keyframes, no local BA run: BA needs 4; no
# loop closed: the closer needs 15 keyframes);
# the Manhattan frame, plane and line numbers are the full path's. Gate:
# ATE <= min(1.5x, 0.02 m), the north star's gate of tests/test_tracker.py.
JAX_DEFAULT_ATE_M = 0.007006
JAX_DEFAULT_LOOPS_CLOSED = 0
# Points and lines the keyframe path triangulated over the run, same script
# (0 and 0: depth landmarks every keypoint of the rendered rooms); the port
# must create as many, within 2 %. The orbit's, then the low-texture room's
# (its points-only run triangulates no lines).
JAX_DEFAULT_TRIANGULATED = {"points": 0, "lines": 0}
JAX_LOW_TEXTURE_TRIANGULATED = {"points_only": {"points": 0, "lines": 0}, "hybrid": {"points": 0, "lines": 0}}
# Low-texture room (tests/test_low_texture.py, the same script): ATE of the
# points-only and of the default configuration, each on a Tracker with its
# defaults (local BA and loop closing on), in metres. The gates are the
# test's own: hybrid < 0.6x points-only and < 0.05 m, on this run's
# numbers; the JAX numbers are printed beside them.
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
# batch_lost: `batch_reference_jax.py --config lost --port-renders`
# (BatchTracker(tum3_config(), 2) over the port's CPU renders of orbits 0
# and 1, sequence 1 blank at frames 6 and 7): ATE RMSE per sequence, the
# frames LOST, and sequence 1's tracked pose at frames 0-11 (`T_cw_tracked`:
# rotation vector of R_cw in rad, then t_cw in m; a LOST frame reports the
# last tracked pose). On the JAX package's own renders, which differ from
# the port's by up to 0.021 gray levels, the same run ends at ATE 0.006051
# / 0.024104 m: sequence 1's recovery at frame 8 (from a prediction ~80 mm
# off) and the local BA runs after it amplify the input's last bits, so
# the references and the card track the same frames. Gates: the same LOST
# frames; ATE within BATCH_LOST_ATE_REL of JAX's both ways, sequence 0
# also <= 0.02 m; sequence 1's tracked poses at frames 0-7, up to the loss
# and through it, within BATCH_LOST_TRACK_GAP (the port on the CPU reads
# <= 1.931 mm and 0.0334 deg there, and 3.376 mm at frame 8; ATE 0.006191
# / 0.015202 m; `--port-cpu`).
BATCH_LOST_SEQS = (0, 1)
BATCH_LOST_BLANK = ((1, 6), (1, 7))
JAX_BATCH_LOST_ATE_M = (0.006010, 0.016583)
JAX_BATCH_LOST_LOST_FRAMES = ((), (6, 7))
JAX_BATCH_LOST_SEQ1_TRACKED = (
    (0.00000000, 0.00000000, 0.00000000, 0.0000000, 0.0000000, 0.8000000),
    (-0.00640176, -0.01415292, 0.00018149, -0.0329508, -0.0071475, 0.7944513),
    (-0.01290634, -0.02781091, 0.00026887, -0.0672129, -0.0148911, 0.7879267),
    (-0.01882578, -0.04030784, 0.00033635, -0.1054509, -0.0206702, 0.7796640),
    (-0.02431928, -0.05393621, 0.00055545, -0.1384892, -0.0263281, 0.7726598),
    (-0.03135711, -0.06471775, 0.00090294, -0.1813201, -0.0366900, 0.7631514),
    (-0.03135711, -0.06471775, 0.00090294, -0.1813201, -0.0366900, 0.7631514),
    (-0.03135711, -0.06471775, 0.00090294, -0.1813201, -0.0366900, 0.7631514),
    (-0.04642918, -0.10792976, 0.00198480, -0.2653958, -0.0521547, 0.7306104),
    (-0.05295218, -0.12159173, 0.00289952, -0.2952936, -0.0634511, 0.7193947),
    (-0.05557984, -0.13441931, 0.00339961, -0.3242793, -0.0632517, 0.7081228),
    (-0.06109216, -0.14788972, 0.00418582, -0.3506171, -0.0730429, 0.6949259),
)
BATCH_LOST_TRACK_GAP = (3e-3, 0.1)
BATCH_LOST_ATE_REL = 0.25
# Relocalization, the JAX suite's gates: kidnapped camera translation error
# (tests/test_reloc.py), the depth-free PnP pose and the frame tracked after
# it (tests/test_reloc_pnp.py).
RELOC_GATE_M, PNP_GATE_M, PNP_TRACK_GATE_M = 0.05, 0.3, 0.03
# Loop closing, card vs CPU on the synthetic loop map with the same RANSAC
# samples: the corrected keyframe poses (the pose graph's) within 0.1 mm
# and 0.01 deg, the corrected landmarks within 0.1 mm; the far-end drift
# below 0.35x its value before (tests/test_pose_graph.py:80). The poses
# after the closure's global BA within 1 mm and 0.01 deg, its cost within
# 0.1 %: on this ring of outward-looking keyframes its translation is
# weakly constrained, and 40 CG steps of float32 sums in another order
# part card and CPU by up to 0.154 mm, 0.0023 deg and 0.0015 % of the cost
# (five runs on an NVIDIA H100 80GB HBM3 at 700 W). Global BA on
# the map of tests/test_global_ba.py:88-126, perturbed as there: median
# pose error after it < 0.015 m; card vs CPU within 5 mm, 0.1 deg and 1 %
# of the cost (the rule of an LM accept that flips,
# test_torch_full_tracker.py::test_f_*).
LOOP_GAP_M, LOOP_GAP_DEG, LOOP_DRIFT_RATIO = 1e-4, 0.01, 0.35
LOOP_GBA_GAP_M, LOOP_GBA_GAP_DEG, LOOP_GBA_COST_REL = 1e-3, 0.01, 1e-3
GBA_MEDIAN_M = 0.015
# Global BA on the low-texture room's map (check_gba_conditioning): in a
# run read on the card, the float32 CPU run rejected the third LM step
# while the card's, a CPU run with the edges in another order and float64
# runs accepted it, and the float32 runs parted by 2-50 mm from then on;
# float64 card and CPU runs agreed to under 1 um. Gates: float32 card vs CPU after 2 iterations (0.150 mm and
# 0.0027 deg read); float64 card vs CPU after all 10 within 0.01 mm,
# 0.001 deg and 1e-5 of the cost (NVIDIA H100 80GB HBM3, 700 W).
GBA_EARLY_ITERS = 2
GBA_F64_GAP = (0.01, 0.001, 1e-5)
# The JAX package's median errors after the same global BA on its own maps
# (`full_reference_jax.py --config default`), printed beside the port's.
JAX_GBA_MEDIAN_M = {"test_global_ba": 0.009741, "low_texture": 0.066346}
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
# cli phase: test_cli_e2e.py's protocol (orbit seed 11, 16 frames) and its
# ATE gate, with the JAX CLI's ATE on the same files (`full_reference_jax.py
# --config cli`: 0.011551 m with --loader python, 0.011644 m native).
# Gate: ATE < min(0.03 m, 1.5x JAX's).
CLI_FRAMES = 16
CLI_ATE_GATE_M = 0.03
JAX_CLI_ATE_M = 0.011551
CLI_SETTINGS = """%YAML:1.0
Camera.fx: 535.4
Camera.fy: 539.2
Camera.cx: 320.1
Camera.cy: 247.6
Camera.width: 640
Camera.height: 480
Camera.fps: 30.0
Camera.bf: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""
# async phase: (pipeline_depth, resolve_burst) runs; depth 24 with groups of
# 12 is bench.py's setting. The frames/s window: ASYNC_FPS_WARM frames
# tracked synchronously, the pipe filled to its depth, then ASYNC_FPS_WINDOW
# timed frames (three times the deepest pipe), over one orbit of
# ASYNC_FPS_FRAMES frames.
ASYNC_DEPTHS = ((1, 0), (24, 12))
# batch_async phase: the JAX package's BatchTracker(tum3_config(), 8)
# through track_batch_async at depths 1 and 2 on the CPU, per orbit
# (`batch_reference_jax.py --config async`). It misses this phase's gate,
# max(2x its track_batch ATE, 0.02 m), on orbit 5 at both depths (the
# pipelined batch resolves each sequence through the single tracker's
# `_post_track`, not the synchronous batch's policy), and at depth 2 it
# diverges on orbits 0, 2, 3 and 6: its chained baseline takes the rigid
# inverse, which the port does not (ROADMAP.md section 3).
JAX_BATCH_ASYNC_ATE_M = {
    1: (0.006658, 0.005290, 0.017169, 0.010059, 0.011300, 0.021812, 0.013701, 0.004386),
    2: (1.252483, 0.025749, 3.356691, 0.499515, 0.009117, 0.021975, 0.592026, 0.004712),
}
ASYNC_FPS_WARM = 2
ASYNC_FPS_WINDOW = 3 * max(d for d, _ in ASYNC_DEPTHS)
ASYNC_FPS_FRAMES = ASYNC_FPS_WARM + max(d for d, _ in ASYNC_DEPTHS) + ASYNC_FPS_WINDOW
# endurance phase: the JAX package on the CPU over the port's renders of
# the same protocols (`full_reference_jax.py --config endurance`), printed
# beside the card's; the gates are tests/test_endurance.py's own.
JAX_ENDURANCE = {
    "points": {"frames": 320, "ok": 320, "kf_live": 24, "kf_total": 41, "ate_rmse_m": 0.007873},
    "full": {"frames": 300, "lost": 0, "kf_total": 12, "n_ba_runs": 9, "loops_closed": 0,
             "ate_rmse_m": 0.008549, "drift_per_window_m": [0.007759, 0.009371, 0.008754]},
}
# The distributed phase (run_distributed): the frames of the batch phase's
# orbits that its sharded batches track; their positions against the
# unsharded batch_full run's (tests/test_multiseq.py::
# test_batch_tracker_sharded_mesh's gate); the ranks of its spawned group
# (two on the one GPU, over gloo); a captured local BA problem solved over the
# ranks against its single-device card solve (check_ba's rule).
DIST_BATCH_FRAMES = 10
DIST_GAP_M = 1e-2
DIST_WORLD = 2
DIST_BA_GAP = (5e-3, 0.1, 0.01)
TIMING_REPS = 50
# The pose LM's check: the fused step's inputs on this frame of each run.
LM_FRAMES = 10
# Kernel against plain on those inputs: pose entries within this, inlier
# masks differing in at most this share of edges, chi2 within 1e-3.
LM_POSE_TOL = 1e-4
LM_MASK_SHARE = 0.01
# The LM's bound counts, each build, ~60 operations a residual row (21 H
# and 6 g multiply-adds and the weighted row) and ~30 an edge to evaluate
# (transform, projection, chi2); the re-classification and final passes
# evaluate each edge once more a round and once at the end.
LM_OPS_PER_ROW = 60.0
LM_OPS_PER_EDGE = 30.0
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


def _lm_launches() -> int:
    """Launches of the pose LM's kernel (one a fused step, whatever S is)."""
    from hfvo_tpu_torch.solve import lm

    return lm.pose_lm_launches


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


def _lm_rows(pts, lines, planes, dirs, axes_c):
    """Residual rows and edges of one LM build, per sequence (the bound's
    counts): point edges 2 rows (3 stereo), metric 3D edges 3, line
    endpoints 1, planes 1 (2 full), directions 3, each axis anchor 3; the
    valid edges only, as the kernel skips the rest."""
    rows = pts.valid.sum(-1) * 2 + (pts.valid & pts.is_stereo).sum(-1)
    edges = pts.valid.sum(-1)
    if pts.X_c_obs is not None:
        has3 = pts.valid & (pts.is_stereo if pts.valid_3d is None else pts.valid_3d)
        rows = rows + 3 * has3.sum(-1)
    if lines is not None:
        rows, edges = rows + lines.valid.sum(-1), edges + lines.valid.sum(-1)
    if planes is not None:
        rows = rows + planes.valid.sum(-1) + (planes.valid & (planes.kind == 0)).sum(-1)
        edges = edges + planes.valid.sum(-1)
    if dirs is not None:
        rows, edges = rows + 3 * dirs.valid.sum(-1), edges + dirs.valid.sum(-1)
    if axes_c is not None:
        rows, edges = rows + 9, edges + 3
    return rows.double().cpu().numpy().reshape(-1), edges.double().cpu().numpy().reshape(-1)


def _lm_builds(call, n_rounds):
    """Normal-equation builds of the plain version for one sequence: each
    build, each round's re-classification and the final chi2 evaluate the
    point terms once."""
    from hfvo_tpu_torch.solve import lm, residuals

    calls = [0]
    inner = residuals.point_stereo_terms_t

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    residuals.point_stereo_terms_t = counted
    try:
        lm.pose_optimization_reference(*call)
    finally:
        residuals.point_stereo_terms_t = inner
    return calls[0] - n_rounds - 1


def _sequence(call, k):
    """Sequence k of a bound (S, ...) call, as an S = 1 call."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return a[k]
        if isinstance(a, tuple) and any(isinstance(x, torch.Tensor) for x in a):  # an edge table
            return type(a)(*(None if x is None else x[k] for x in a))
        return a
    return [one(a) for a in call]


def check_pose_lm(device, cycles_per_ms, seqs, build_log):
    """The pose LM's kernel on the fused step's own inputs: those of the
    LM_FRAMES-th frame of a default-config VOSystem (S = 1, local BA off: it
    changes the map, not the tables' shapes) and of an N_SEQ-sequence
    BatchTracker, captured at `tracking.tracker.pose_optimization`. Each
    against the plain version (the pose within LM_POSE_TOL, inlier masks
    within LM_MASK_SHARE, chi2 within 1e-3), twice bit-equal, the batch's
    sequences each bit-equal to their own S = 1 launch; timed beside the
    plain version and the bound, with the thread count's ablation. A traced
    run of the VOSystem's frames counts one `lm_kernel` a fused step and no
    `lm_test`. Returns its table row."""
    from hfvo_tpu_torch import tracing
    from hfvo_tpu_torch.config import tum3_config
    from hfvo_tpu_torch.ops import _kernels
    from hfvo_tpu_torch.solve import lm
    from hfvo_tpu_torch.tracking import tracker as trk

    captured = {}
    inner = trk.pose_optimization
    signature = inspect.signature(lm.pose_optimization)

    def keep(*a, **kw):
        bound_args = signature.bind(*a, **kw)
        bound_args.apply_defaults()
        captured[1 if a[0].dim() == 2 else a[0].shape[0]] = list(bound_args.args)
        return inner(*a, **kw)

    tracing.disable()
    tracing.drain()
    trk.pose_optimization = keep
    try:
        tracing.enable()
        try:
            system, *_ = run_system(device, tum3_config(), seqs[0][1], seqs[0][2], LM_FRAMES)
        finally:
            tracing.disable()
        run_batch(device, tum3_config(), seqs, LM_FRAMES, range(N_SEQ))
    finally:
        trk.pose_optimization = inner
    rec = tracing.drain()
    counts = {}
    for c in rec.counts:
        counts[c.name] = counts.get(c.name, 0) + c.n
    steps = sum(sp.name == "fused_step" for sp in rec.spans)
    log(f"pose_lm: traced VOSystem frames 0-{LM_FRAMES - 1}: {steps} fused steps, lm_kernel "
        f"{counts.get('lm_kernel', 0)}, lm_test {counts.get('lm_test', 0)}, host_sync {counts.get('host_sync', 0)}")
    if steps == 0 or counts.get("lm_kernel", 0) != steps or counts.get("lm_test", 0):
        raise AssertionError(f"pose_lm: {steps} fused steps, counts {counts}")
    del system

    info = [ln.strip() for ln in build_log.splitlines() if "registers" in ln or "spill" in ln]
    out = {}
    for S, call in sorted(captured.items()):
        n_rounds = call[9]
        T, pts, lines, planes = call[0], call[1], call[3], call[4]
        sizes = dict(N=pts.X_w.shape[-2], M=0 if lines is None else lines.X_w.shape[-2],
                     P=0 if planes is None else planes.pi_w.shape[-2],
                     V=0 if call[5] is None else call[5].d_w.shape[-2], axes=call[6] is not None,
                     metric3d=pts.X_c_obs is not None)
        got = lm.pose_optimization(*call)
        again = lm.pose_optimization(*call)
        want = lm.pose_optimization_reference(*call)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"pose_lm S={S}: two launches on the same inputs differ")
        d_pose = float((got.T_cw - want.T_cw).abs().max())
        n_edges = sum(x.shape[-1] for x in (got.inlier, got.line_inlier, got.plane_inlier))
        d_mask = sum(int((a != b).sum()) for a, b in zip((got.inlier, got.line_inlier, got.plane_inlier),
                                                         (want.inlier, want.line_inlier, want.plane_inlier)))
        d_chi2 = float(((got.chi2 - want.chi2).abs() / want.chi2.abs().clamp(min=1e-3)).max())
        log(f"pose_lm S={S} {sizes}: kernel vs plain max pose entry gap {d_pose:.3g}, inlier flags differing "
            f"{d_mask} of {n_edges * S}, chi2 rel gap {d_chi2:.3g}; n_inliers "
            f"{got.n_inliers.cpu().tolist()} vs {want.n_inliers.cpu().tolist()}")
        if not (d_pose <= LM_POSE_TOL and d_mask <= LM_MASK_SHARE * n_edges * S and d_chi2 <= 1e-3):
            raise AssertionError(f"pose_lm S={S}: kernel departs from the plain version")
        singles = [_sequence(call, k) for k in range(S)] if S > 1 else [call]
        if S > 1:
            for k, one in enumerate(singles):
                alone = lm.pose_optimization(*one)
                if not all(torch.equal(a[k], b) for a, b in zip(got, alone)):
                    raise AssertionError(f"pose_lm S={S}: sequence {k} differs from its own S = 1 launch")
        builds = [_lm_builds(one, n_rounds) for one in singles]
        rows, edges = _lm_rows(*(call[i] for i in (1, 3, 4, 5, 6)))
        ops = float(sum(b * (LM_OPS_PER_ROW * r + LM_OPS_PER_EDGE * e) + (n_rounds + 1) * LM_OPS_PER_EDGE * e
                        for b, r, e in zip(builds, rows, edges)))
        nbytes = float(sum(x.numel() * x.element_size() for a in call if a is not None
                           for x in ((a,) if isinstance(a, torch.Tensor) else a if isinstance(a, tuple) else ())
                           if isinstance(x, torch.Tensor))
                       + sum(x.numel() * x.element_size() for x in got))
        b_ms, b_by = bound(nbytes, ops)
        k_dev, k_call = device_ms(lambda: lm.pose_optimization(*call), cycles_per_ms)
        p_dev, p_call = device_ms(lambda: lm.pose_optimization_reference(*call), cycles_per_ms, reps=5)
        ablation = {}
        for threads in (128, 256, 512):
            ablation[threads] = device_ms(lambda: lm._launch(*call, threads=threads), cycles_per_ms)[0]
        log(f"pose_lm S={S}: plain builds a sequence {builds}; device ms kernel {k_dev:.5f} plain {p_dev:.5f} "
            f"(host-synced: its device ms hold the host's launch gaps); call ms kernel {k_call:.5f} plain "
            f"{p_call:.5f}; bound ms {b_ms:.6f} ({b_by}: {nbytes:.0f} B, {ops:.4g} operations); "
            f"threads a block -> device ms {ablation}; ptxas {' | '.join(info)}")
        out[S] = dict(ms=k_dev, call_ms=k_call, plain_ms=p_dev, plain_call_ms=p_call, bound_ms=b_ms,
                      bound_by=b_by, max_pose_gap=d_pose, flags_differing=d_mask, builds=builds,
                      threads_ablation_ms=ablation, sizes=sizes)
    one, batch = out[1], out[N_SEQ]
    return {"pose_optimization": {
        "name": "pose_optimization", "id": "LM", "route": "cuda", "source": "hfvo_tpu_torch/csrc/pose_lm.cu",
        "replaces": None, **one, "batched": batch, "library_ms": None, "ptxas": info,
        "spill_bytes": _kernels.spill_bytes(build_log),
        "ms_is": f"device time of one pose_optimization call on the fused step's inputs of frame {LM_FRAMES} "
                 f"(S = 1; `batched`: the {N_SEQ}-sequence batch's)"}}


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


def run_system(device, cfg, grays, depths, n, use_local_ba=False, use_loop_closing=False):
    """Drive VOSystem.track_rgbd over the first `n` frames. Returns
    (system, results, per-frame wall seconds, per-frame dict of inlier line
    matches "lines", inlier full plane matches "planes" and "manh_valid",
    and the keyframe path's log "kf" (keyframe_path_log))."""
    from hfvo_tpu_torch.system import VOSystem

    system = VOSystem(cfg, device, use_local_ba=use_local_ba, use_loop_closing=use_loop_closing)
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
             jax_triangulated=None, use_loop_closing=False):
    """One path: its run with the launch counts reset just before and read
    just after, then its output checks (with local BA: the keyframe path's,
    against `jax_triangulated`). Returns (launches, median ms a tracked
    frame, p90, ATE RMSE); `lines_ms` is logged beside the full and default
    paths'."""
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.tracking.tracker import TrackState

    T_wc, grays, depths = frames
    reset_counts()
    lm0 = _lm_launches()
    system, results, secs, per = run_system(device, cfg, grays, depths, N_FRAMES, use_local_ba,
                                            use_loop_closing)
    n_lines, n_planes, manh = per["lines"], per["planes"], per["manh_valid"]
    torch.cuda.synchronize()
    launches = read_counts()
    n_lm = _lm_launches() - lm0
    # The initialization extracts one (H, W) frame (K1, K3); a tracked frame
    # runs the fused step at S = 1 on a (1, H, W) stack (K1b, K3b). One FAST
    # launch an extraction, for all its levels.
    stages = system.tracker.stage_times
    inits, steps = stages.get("init_extract", [0, 0])[1], stages.get("fused_step", [0, 0])[1]
    want = {"fast_score_dual": inits, "fast_score_dual_batched": steps,
            "fast_score": 0, "fast_score_batched": 0,
            "hough_vote": inits if cfg.use_lines else 0,
            "hough_vote_batched": steps if cfg.use_lines else 0}
    if launches != want or inits == 0 or steps == 0 or n_lm != steps:
        raise AssertionError(f"{name}: launches {launches}, want {want} ({inits} inits, {steps} steps); "
                             f"pose LM {n_lm}, want one a step")
    launches["pose_optimization"] = n_lm

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
    if use_loop_closing:
        loops = system.tracker.loop_closer.n_loops_closed
        log(f"{name}: loop closing on, {loops} loops closed (JAX {JAX_DEFAULT_LOOPS_CLOSED}), auto_reset "
            f"{system.tracker.auto_reset}")
        if loops != JAX_DEFAULT_LOOPS_CLOSED:
            raise AssertionError(f"{name}: {loops} loops closed, the JAX package's run {JAX_DEFAULT_LOOPS_CLOSED}")
    if use_local_ba:
        check_triangulated(name, per["kf"], jax_triangulated)
        if per["kf"]["ba"]:
            check_ba(name, [per["kf"]], cfg.camera)
        check_triangulation(name, system.tracker, cfg, device)

    _, cpu_results, _, cpu_per = run_system("cpu", cfg, grays, depths, N_CPU_FRAMES, use_local_ba,
                                            use_loop_closing)
    cpu_lines = cpu_per["lines"]
    for i, (a, b) in enumerate(zip(results, cpu_results)):
        dt, dr = pose_gap(a.T_cw, b.T_cw)
        log(
            f"{name} frame {i}: card vs CPU {dt * 1e3:.4f} mm {dr:.5f} deg, matches "
            f"{a.n_matches} vs {b.n_matches}, line inliers {n_lines[i]} vs {cpu_lines[i]}"
        )
        if not (dt < CPU_GAP_M and dr < CPU_GAP_DEG) or a.is_keyframe != b.is_keyframe:
            raise AssertionError(f"{name} frame {i}: the card's run departs from the CPU run")
    return launches, float(np.median(tracked_ms)), float(np.percentile(tracked_ms, 90)), float(ate)


def run_low_texture(device, card):
    """The JAX suite's low-texture test on the card: the low-texture room
    (`make_room(0, low_texture=True)`, 20 orbit frames, rendered on the
    card), tracked by a points-only configuration and by `tum3_config()`,
    each on a fresh Tracker with its defaults (local BA, loop closing and the
    early-loss reset on), started at the ground-truth pose of frame 0. The
    launch counts are reset just before the default configuration's run and
    read just after. Returns (launches, the BA logs, the default
    configuration's tracker)."""
    from hfvo_tpu_torch.config import tum3_config
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.testing import synthetic
    from hfvo_tpu_torch.tracking.tracker import Tracker, TrackState

    n = LOW_TEXTURE_FRAMES
    T_wc, grays, depths = synthetic.render_sequence(
        n=n, scene=synthetic.make_room(0, low_texture=True, device=device), device=device)
    c = tum3_config()
    ts = np.arange(n) / 30.0
    ates, logs, trackers = {}, {}, {}
    for key, cfg in (("points_only", c.replace(use_lines=False, use_planes=False, use_manhattan=False)),
                     ("hybrid", c)):
        if key == "hybrid":
            reset_counts()
        tr = Tracker(cfg, device)
        trackers[key] = tr
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
    return launches, logs, trackers["hybrid"]


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
    Returns (launches, median ms a call, p90, frames/s, BA logs, ATE RMSE
    per sequence)."""
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.tracking.tracker import TrackState

    reset_counts()
    lm0 = _lm_launches()
    bt, results, secs, n_lines, n_planes, logs = run_batch(device, cfg, seqs, N_FRAMES, range(N_SEQ), use_local_ba)
    torch.cuda.synchronize()
    launches = read_counts()
    n_lm = _lm_launches() - lm0
    steps = N_FRAMES - 1
    want = {"fast_score_dual": N_SEQ, "fast_score_dual_batched": steps,
            "fast_score": 0, "fast_score_batched": 0,
            "hough_vote": N_SEQ, "hough_vote_batched": steps}
    if launches != want or n_lm != steps:
        raise AssertionError(f"{name}: launches {launches}, want {want}; pose LM {n_lm}, want {steps}")
    launches["pose_optimization"] = n_lm

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
    failed, plane_seqs, ates = [], 0, []
    for s, (tr, est) in enumerate(zip(bt.trackers, bt.get_trajectories())):
        states = [r[s].state for r in results]
        n_lost = sum(st is not TrackState.OK for st in states)
        ate = float(evaluate.ate(ts, seqs[s][0], ts, est, align="origin").rmse) \
            if est.shape == (N_FRAMES, 4, 4) and np.isfinite(est).all() else float("nan")
        ates.append(ate)
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
    return launches, float(np.median(batch_ms)), float(np.percentile(batch_ms, 90)), fps, logs, ates, results


def _device_spans(prof):
    """(start, end) in microseconds of every device event (kernels, copies,
    fills) of a finished torch.profiler run, read from the raw trace when
    it is there (building the profiler's per-event objects for ~100,000
    events takes seconds), else from its events."""
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kineto is not None and hasattr(kineto, "events"):
        evs = [e for e in kineto.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()]
        if evs and hasattr(evs[0], "start_ns"):
            return [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3) for e in evs]
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def _busy_ms(spans) -> float:
    """Length of the union of the device intervals (microseconds), ms."""
    spans = sorted(spans)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def device_profile(make) -> dict:
    """Wall ms of one call of `make()` (a fresh zero-argument callable each
    time, so a call that changes state starts from the same one), then the
    same call of a fresh callable under torch.profiler: its device-busy ms,
    device ops (kernels, copies, fills) and the device's idle share of the
    unprofiled wall time."""
    fn = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    fn = make()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = _device_spans(prof)
    busy = _busy_ms(dev)
    return {"wall_ms": wall, "device_busy_ms": busy, "device_ops": len(dev), "idle_share": 1.0 - busy / wall,
            "profile_s": time.perf_counter() - t0}


def _blank(gray_np, depth_np, zero_depth=True, level=120.0):
    """A featureless frame: uniform gray `level`, and zero depth or the
    given one."""
    return np.full_like(gray_np, level), (np.zeros_like(depth_np) if zero_depth else depth_np)


def run_reloc(device, card, frames) -> dict:
    """Relocalization at 640x480 by the JAX suite's protocols, with the
    launch counts reset just before and read just after:
    - kidnapped camera (tests/test_reloc.py): `Tracker(tum3_config(),
      use_local_ba=False, auto_reset=False)` tracks frames 0-7, two blank
      frames with zero depth put it LOST, then frame 1 must come back OK
      within 5 cm;
    - depth-free branch (tests/test_reloc_pnp.py): the same run to LOST,
      then `_relocalize` on frame 1 with zero depth must return a pose
      within 0.3 m (the PnP branch), and the tracked frame 1 within 3 cm;
    - textureless frame (tests/test_tracker.py:119-132): a `Tracker` with
      its defaults over frames 0-9 with frame 5 blank (real depth): at most
      1 LOST frame and OK at the end.
    Logs each relocalization's branch and ms. Returns the launch counts."""
    from hfvo_tpu_torch.config import tum3_config
    from hfvo_tpu_torch.tracking.tracker import Tracker, TrackState

    T_wc, grays, depths = frames
    cfg = tum3_config()
    init = np.linalg.inv(T_wc[0])
    reset_counts()
    trackers = []

    def to_lost():
        tr = Tracker(cfg, device, use_local_ba=False, auto_reset=False)
        trackers.append(tr)
        for i in range(8):
            tr.track_rgbd(grays[i], depths[i], T_cw_init=init)
        for _ in range(2):
            r = tr.track_rgbd(*_blank(grays[0], depths[0]))
        if r.state is not TrackState.LOST or tr.vomap.n_keyframes() < 2:
            raise AssertionError(f"reloc: blank frames left the tracker {r.state.name}, "
                                 f"{tr.vomap.n_keyframes()} keyframes")
        return tr

    def t_err(T_cw, i):
        return float(np.abs(T_cw[:3, 3] - np.linalg.inv(T_wc[i])[:3, 3]).max())

    tr = to_lost()
    before = tr.stage_times["relocalize"][0]
    t0 = time.perf_counter()
    r = tr.track_rgbd(grays[1], depths[1])
    ms = (time.perf_counter() - t0) * 1e3
    kid_err = t_err(r.T_cw, 1) if r.state is TrackState.OK else float("inf")
    log(f"reloc kidnapped ({card}): state {r.state.name}, branch {tr.last_reloc}, relocalize "
        f"{(tr.stage_times['relocalize'][0] - before) * 1e3:.3f} ms, frame with relocalization {ms:.3f} ms, "
        f"translation error {kid_err:.6f} m (gate {RELOC_GATE_M})")

    tr = to_lost()
    gray = tr._upload(np.clip(grays[1], 0, 255).astype(np.uint8)[None])
    no_depth = tr._upload(np.zeros((1,) + tuple(depths[1].shape), np.int32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T_pnp = tr._relocalize(gray, no_depth)
    ms_pnp = (time.perf_counter() - t0) * 1e3
    pnp_branch = tr.last_reloc
    pnp_err = t_err(T_pnp, 1) if T_pnp is not None else float("inf")
    tr.state = TrackState.LOST
    r2 = tr.track_rgbd(grays[1], depths[1])
    pnp_track_err = t_err(r2.T_cw, 1) if r2.state is TrackState.OK else float("inf")
    log(f"reloc depth-free ({card}): branch {pnp_branch}, relocalize "
        f"{ms_pnp:.3f} ms, pose error {pnp_err:.6f} m (gate {PNP_GATE_M}); next frame {r2.state.name} "
        f"(branch {tr.last_reloc}), error {pnp_track_err:.6f} m (gate {PNP_TRACK_GATE_M})")

    tr = Tracker(cfg, device)
    trackers.append(tr)
    states = []
    for i in range(10):
        g, d = (grays[i], depths[i]) if i != 5 else _blank(grays[i], depths[i], zero_depth=False, level=128.0)
        states.append(tr.track_rgbd(g, d, T_cw_init=init).state)
    n_lost = sum(st is TrackState.LOST for st in states)
    log(f"reloc textureless frame ({card}): states {[st.name for st in states]}, LOST {n_lost}")

    torch.cuda.synchronize()
    launches = read_counts()
    inits = sum(t.stage_times.get("init_extract", [0, 0])[1] for t in trackers)
    relocs = sum(t.stage_times.get("relocalize", [0, 0])[1] for t in trackers) + 1  # + the direct call
    steps = sum(t.stage_times.get("fused_step", [0, 0])[1] for t in trackers)
    want = {"fast_score_dual": inits + relocs, "fast_score_dual_batched": steps, "fast_score": 0,
            "fast_score_batched": 0, "hough_vote": inits, "hough_vote_batched": steps}
    log(f"reloc: launches {launches} ({inits} inits, {relocs} relocalizations, {steps} steps)")
    if launches != want:
        raise AssertionError(f"reloc: launches {launches}, want {want}")
    if not (kid_err < RELOC_GATE_M and pnp_err < PNP_GATE_M and pnp_track_err < PNP_TRACK_GATE_M
            and pnp_branch is not None and pnp_branch[0] == "pnp"):
        raise AssertionError(f"reloc: errors {kid_err}, {pnp_err}, {pnp_track_err} m over their gates")
    if not (n_lost <= 1 and states[-1] is TrackState.OK):
        raise AssertionError(f"reloc: textureless run {[st.name for st in states]}")
    return launches


def _loop_closer(device, cfg):
    """The synthetic loop map in a fresh VOMap, and a LoopCloser on `device`
    with a tracker stand-in (keyframe database, local mapper, snapshot
    hook)."""
    import types

    from hfvo_tpu_torch.bow.database import KeyFrameDatabase
    from hfvo_tpu_torch.mapping.local_mapping import LocalMapper
    from hfvo_tpu_torch.mapping.loop_closing import LoopCloser
    from hfvo_tpu_torch.testing import loop_map
    from hfvo_tpu_torch.vomap.map import VOMap

    vm, db = VOMap(cfg), KeyFrameDatabase(cfg.cap.keyframes)
    gt = loop_map.build_loop_map(vm, db, cfg)
    trk = types.SimpleNamespace(kf_db=db, mapper=LocalMapper(cfg, vm, device), invalidate_map_snapshot=lambda: None)
    return LoopCloser(cfg, vm, device), trk, vm, gt


def run_loop(device, card, gba_vomap, cam) -> dict:
    """Loop closing on the card against the CPU, and its times.

    On the synthetic loop map, `detect_and_close` runs twice (the
    consistency gate) on the card and on the CPU from the same state, both
    with the RANSAC samples drawn on the CPU. Gates: the same decisions;
    keyframe poses after the pose graph within 0.1 mm / 0.01 deg and after
    the global BA within 1 mm / 0.01 deg with the cost within 0.1 %,
    corrected landmarks within 0.1 mm, the same points
    fused and planes merged; the far-end drift below 0.35x its value before.
    Then the global BA check (check_gba, camera `cam`) on the map of
    tests/test_global_ba.py and on `gba_vomap`. Times, with
    device ops and idle share: a closure, its pose graph, a global BA.
    Returns the launch counts of the phase (it runs no FAST or Hough)."""
    import copy

    from hfvo_tpu_torch.config import tum3_config
    from hfvo_tpu_torch.mapping import loop_closing
    from hfvo_tpu_torch.solve import global_ba, ransac

    cfg = tum3_config()
    reset_counts()
    draw = ransac.draw_samples
    ransac.draw_samples = lambda valid, n, k, seed: draw(valid.cpu(), n, k, seed).to(valid.device)
    pg_fn, gba_fn = loop_closing.optimize_pose_graph, loop_closing.run_global_ba
    seen = {}

    def capture(key, fn, store_map=False):
        def wrapped(*a, **kw):
            if store_map:
                seen.setdefault(key, []).append(copy.deepcopy(a[0]))
            else:
                seen.setdefault(key, []).append(a[0])
            out = fn(*a, **kw)
            if store_map:
                seen.setdefault("gba_chi2", []).append(out)
            return out
        return wrapped

    loop_closing.optimize_pose_graph = capture("pg", pg_fn)
    loop_closing.run_global_ba = capture("pre_gba", gba_fn, store_map=True)
    try:
        out = {}
        for dev in (device, "cpu"):
            lc, trk, vm, gt = _loop_closer(dev, cfg)
            T0 = vm.keyframes.T_cw[gt["slots"]].copy()
            n_pts = int(vm.points.valid.sum())
            first = lc.detect_and_close(trk)
            t0 = time.perf_counter()
            second = lc.detect_and_close(trk)
            ms = (time.perf_counter() - t0) * 1e3
            out[str(dev)] = dict(decisions=(first, second), ms=ms, vm=vm, pre=seen["pre_gba"][-1], T0=T0,
                                 gt=gt, fused=n_pts - int(seen["pre_gba"][-1].points.valid.sum()),
                                 pg=seen["pg"][-1])
        a, b = out[str(device)], out["cpu"]
        gt = a["gt"]
        slots = gt["slots"]
        pg_gap = max(pose_gap(x, y) for x, y in zip(a["pre"].keyframes.T_cw[slots], b["pre"].keyframes.T_cw[slots]))
        fin_gap = max(pose_gap(x, y) for x, y in zip(a["vm"].keyframes.T_cw[slots], b["vm"].keyframes.T_cw[slots]))
        lm_gap = max(float(np.abs(getattr(getattr(a["pre"], t), f) - getattr(getattr(b["pre"], t), f)).max())
                     for t, f in (("points", "X_w"), ("lines", "X0_w"), ("lines", "X1_w"), ("planes", "pi_w")))
        drift0 = np.linalg.norm(a["T0"][-1][:3, 3] - gt["T_true"][-1][:3, 3])
        drift1 = np.linalg.norm(a["pre"].keyframes.T_cw[slots[-1]][:3, 3] - gt["T_true"][-1][:3, 3])
        same_fuse = np.array_equal(a["pre"].points.valid, b["pre"].points.valid) and np.array_equal(
            a["pre"].planes.valid, b["pre"].planes.valid)
        log(f"loop ({card}): decisions card {a['decisions']} CPU {b['decisions']}; first closure ms card "
            f"{a['ms']:.3f} (with the card's first use of these ops) CPU {b['ms']:.3f}; card vs CPU after the pose graph {pg_gap[0] * 1e3:.5f} mm {pg_gap[1]:.6f} deg, "
            f"landmarks {lm_gap * 1e3:.5f} mm, after the global BA {fin_gap[0] * 1e3:.5f} mm {fin_gap[1]:.6f} deg; "
            f"fused points card {a['fused']} CPU {b['fused']}, same fuse and merge {same_fuse}; far-end drift "
            f"{drift0:.6f} -> {drift1:.6f} m (gate {LOOP_DRIFT_RATIO}x)")
        if not (a["decisions"] == b["decisions"] == (False, True)):
            raise AssertionError(f"loop: decisions card {a['decisions']} CPU {b['decisions']}")
        chi2 = [float(x) for x in (seen["gba_chi2"][0], seen["gba_chi2"][1])]
        log(f"loop: the closure's global BA cost card {chi2[0]:.4f} CPU {chi2[1]:.4f}")
        if not (pg_gap[0] < LOOP_GAP_M and pg_gap[1] < LOOP_GAP_DEG and lm_gap < LOOP_GAP_M and same_fuse
                and a["fused"] > 0):
            raise AssertionError("loop: the card's closure departs from the CPU's")
        if not (fin_gap[0] < LOOP_GBA_GAP_M and fin_gap[1] < LOOP_GBA_GAP_DEG
                and abs(chi2[0] - chi2[1]) <= LOOP_GBA_COST_REL * chi2[1]):
            raise AssertionError("loop: the card's global BA after the closure departs from the CPU's")
        if not drift1 < LOOP_DRIFT_RATIO * drift0:
            raise AssertionError(f"loop: far-end drift {drift0} -> {drift1} m")

        def closure():
            lc, trk, _, _ = _loop_closer(device, cfg)
            lc.detect_and_close(trk)
            return lambda: lc.detect_and_close(trk)

        pg = a["pg"]
        prof = {"closure": device_profile(closure),
                "pose_graph": device_profile(lambda: lambda: loop_closing.optimize_pose_graph(pg))}
        for key, p in prof.items():
            log(f"loop {key} ({card}): wall {p['wall_ms']:.3f} ms, device busy {p['device_busy_ms']:.3f} ms, "
                f"{p['device_ops']} device ops, idle {100 * p['idle_share']:.1f} % (profiled run and its "
                f"trace {p['profile_s']:.1f} s)")
        gba = check_gba(device, card, {"test_global_ba": gba_test_map(device), "low_texture": gba_vomap}, cam)
        prob = global_ba.build_global_ba_problem(gba["test_global_ba"][0], gauge_kf=gba["test_global_ba"][1],
                                                 device=device)[0]
        prof = {"global_ba": device_profile(lambda: lambda: global_ba.global_bundle_adjustment(prob, cfg.camera))}
        for key, p in prof.items():
            log(f"loop {key} ({card}): wall {p['wall_ms']:.3f} ms, device busy {p['device_busy_ms']:.3f} ms, "
                f"{p['device_ops']} device ops, idle {100 * p['idle_share']:.1f} % (profiled run and its "
                f"trace {p['profile_s']:.1f} s)")
        log(f"loop: pose graph K {pg.T_cw.shape[0]} E {pg.e_i.shape[0]}; global BA K {prob.kf_T_cw.shape[0]} "
            f"landmarks {prob.pt_X.shape[0]} edges {prob.e_kf.shape[0]} line edges {prob.le_kf.shape[0]}")
    finally:
        ransac.draw_samples = draw
        loop_closing.optimize_pose_graph, loop_closing.run_global_ba = pg_fn, gba_fn
    torch.cuda.synchronize()
    return read_counts()


def _perturbed(vomap):
    """A copy of `vomap` with every keyframe pose but the oldest's perturbed
    by a 1 cm / 0.01 rad twist (seed 7), as tests/test_global_ba.py:106-116
    perturbs its map. Returns (the copy, keyframe slots, their poses before,
    the gauge slot)."""
    import copy

    from hfvo_tpu_torch.geometry import se3

    vm = copy.deepcopy(vomap)
    kf = vm.keyframes
    slots = np.nonzero(kf.valid)[0]
    T_before = kf.T_cw[slots].copy()
    gauge = int(slots[np.argsort(kf.order[slots], kind="stable")[0]])
    rs = np.random.default_rng(7)
    for s in slots:
        if s != gauge:
            xi = torch.from_numpy((rs.normal(size=6) * 0.01).astype(np.float32))
            kf.T_cw[s] = se3.exp_se3(xi).numpy() @ kf.T_cw[s]
    return vm, slots, T_before, gauge


def gba_test_map(device):
    """The map of tests/test_global_ba.py::test_run_global_ba_on_tracker_map,
    tracked on the card: `render_sequence(n=14, seed=3)`, tum3 with a
    keyframe at least every 2 frames, local BA and loop closing off."""
    import dataclasses

    from hfvo_tpu_torch.config import tum3_config
    from hfvo_tpu_torch.testing import synthetic
    from hfvo_tpu_torch.tracking.tracker import Tracker

    cfg = tum3_config()
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, max_frames_between_kf=2))
    T_wc, grays, depths = synthetic.render_sequence(n=14, seed=3, device=device)
    tr = Tracker(cfg, device, use_local_ba=False, use_loop_closing=False)
    for g, d in zip(grays, depths):
        tr.track_rgbd(g, d, T_cw_init=np.linalg.inv(T_wc[0]))
    return tr.vomap


def check_gba(device, card, maps, cam) -> dict:
    """A global BA from each map of `maps` (name -> VOMap), run as
    tests/test_global_ba.py:88-126 runs it: the map perturbed (_perturbed),
    then `run_global_ba` with the oldest keyframe as the gauge, on the card
    and on the CPU. Gates on the JAX test's own map ("test_global_ba"):
    median keyframe translation error against the map before the
    perturbation < 0.015 m, card vs CPU within 5 mm, 0.1 deg and 1 % of the
    cost. On the low-texture room's final map ("low_texture") the global
    BA, whose edges are points and line endpoints alone, pulls the poses
    away from the tracker's, the JAX package's too (`full_reference_jax.py
    --config default`), and float32 runs part after its first LM accept
    that flips: check_gba_conditioning holds that map. Returns {name:
    (perturbed map, gauge slot)}."""
    import copy

    from hfvo_tpu_torch.solve.global_ba import run_global_ba

    out = {}
    for name, vomap in maps.items():
        vm, slots, T_before, gauge = _perturbed(vomap)
        if len(slots) < 5:
            raise AssertionError(f"global BA {name}: the map holds {len(slots)} keyframes, under 5")
        res = {}
        for dev in (device, "cpu"):
            m = copy.deepcopy(vm)
            t0 = time.perf_counter()
            chi2 = run_global_ba(m, cam, gauge_kf=gauge, device=dev)
            res[str(dev)] = (m, chi2, (time.perf_counter() - t0) * 1e3)
        (m_c, chi2_c, ms_c), (m_p, chi2_p, ms_p) = res[str(device)], res["cpu"]
        err = np.linalg.norm(m_c.keyframes.T_cw[slots][:, :3, 3] - T_before[:, :3, 3], axis=1)
        med, med0 = float(np.median(err)), float(np.median(np.linalg.norm(
            vm.keyframes.T_cw[slots][:, :3, 3] - T_before[:, :3, 3], axis=1)))
        gaps = [pose_gap(x, y) for x, y in zip(m_c.keyframes.T_cw[slots], m_p.keyframes.T_cw[slots])]
        dt, dr = max(g[0] for g in gaps), max(g[1] for g in gaps)
        gated = name == "test_global_ba"
        log(f"global BA {name} ({card}): {len(slots)} keyframes, run_global_ba card {ms_c:.3f} ms CPU {ms_p:.3f} "
            f"ms; median pose error {med0:.6f} m perturbed -> {med:.6f} m after (JAX {JAX_GBA_MEDIAN_M[name]}, gate "
            f"{GBA_MEDIAN_M if gated else 'none'}); card vs CPU {dt * 1e3:.5f} mm {dr:.6f} deg, cost "
            f"{chi2_c:.4f} vs {chi2_p:.4f}")
        if not (np.isfinite(m_c.keyframes.T_cw).all() and np.isfinite(chi2_c)):
            raise AssertionError(f"global BA {name}: non-finite result")
        if gated and not (med < GBA_MEDIAN_M and dt < 5e-3 and dr < 0.1 and abs(chi2_c - chi2_p) <= 0.01 * chi2_p):
            raise AssertionError(f"global BA {name}: over its gates")
        if not gated:
            check_gba_conditioning(device, card, name, vm, gauge, cam)
        out[name] = (vm, gauge)
    return out


def _gba_gap(a, b):
    """(max mm, max deg, relative cost gap) between two GlobalBAResults."""
    gaps = [pose_gap(x, y) for x, y in zip(*(r.kf_T_cw.double().cpu().numpy() for r in (a, b)))]
    ca, cb = float(a.chi2), float(b.chi2)
    return 1e3 * max(g[0] for g in gaps), max(g[1] for g in gaps), abs(ca - cb) / abs(cb)


def check_gba_conditioning(device, card, name, vm, gauge, cam) -> None:
    """The card's global BA against the CPU's on a map where float32 runs
    part (the low-texture room's). Gates: after GBA_EARLY_ITERS LM
    iterations, before the first accept that flips, float32 card vs CPU
    within 5 mm, 0.1 deg and 1 % of the cost; the whole run (10 iterations)
    in float64, card vs CPU within GBA_F64_GAP. Measured besides: the whole
    float32 run on the card (twice: its scatter-adds sum in no fixed
    order), on the CPU and on the CPU with the edges in another order (a
    seeded permutation), against the CPU's float32 and float64 runs."""
    from hfvo_tpu_torch.solve import global_ba

    def f64(prob):
        return type(prob)(**{k: v.double() if v.is_floating_point() else v for k, v in prob._asdict().items()})

    def permuted(prob):
        rs = np.random.default_rng(1)
        d = prob._asdict()
        for keys, n in ((("e_kf", "e_pt", "e_obs", "e_stereo", "e_inv_sigma2", "e_valid"), prob.e_kf.shape[0]),
                        (("le_kf", "le_lm", "le_line2d", "le_inv_sigma2", "le_valid"), prob.le_kf.shape[0])):
            order = torch.from_numpy(rs.permutation(n))
            for k in keys:
                d[k] = d[k][order]
        return type(prob)(**d)

    pc = global_ba.build_global_ba_problem(vm, gauge, device=device)[0]
    pp = global_ba.build_global_ba_problem(vm, gauge, device="cpu")[0]
    solve = global_ba.global_bundle_adjustment
    early = _gba_gap(solve(pc, cam, n_iters=GBA_EARLY_ITERS), solve(pp, cam, n_iters=GBA_EARLY_ITERS))
    runs = {"card": solve(pc, cam), "CPU": solve(pp, cam), "CPU, edges permuted": solve(permuted(pp), cam)}
    again = _gba_gap(solve(pc, cam), runs["card"])
    r64 = {"card": solve(f64(pc), cam), "CPU": solve(f64(pp), cam)}
    full64 = _gba_gap(r64["card"], r64["CPU"])
    f32 = {k: _gba_gap(r, runs["CPU"]) for k, r in runs.items() if k != "CPU"}
    to64 = {k: _gba_gap(r, r64["CPU"])[0] for k, r in runs.items()}
    log(f"global BA {name} conditioning ({card}): float32 card vs CPU after {GBA_EARLY_ITERS} iterations "
        f"{early[0]:.5f} mm {early[1]:.6f} deg cost {100 * early[2]:.5f} %; float64, 10 iterations, card vs CPU "
        f"{full64[0]:.6f} mm {full64[1]:.7f} deg cost {100 * full64[2]:.7f} % (cost {float(r64['CPU'].chi2):.4f}); "
        f"float32, 10 iterations, against the CPU's: "
        + ", ".join(f"{k} {g[0]:.5f} mm {g[1]:.6f} deg cost {100 * g[2]:.5f} %" for k, g in f32.items())
        + f"; a second card run against the first {again[0]:.5f} mm {again[1]:.6f} deg cost {100 * again[2]:.5f} %"
        + "; float32 runs to the float64 run: " + ", ".join(f"{k} {v:.5f} mm" for k, v in to64.items()))
    if not (early[0] < 5.0 and early[1] < 0.1 and early[2] <= 0.01):
        raise AssertionError(f"global BA {name}: float32 card vs CPU after {GBA_EARLY_ITERS} iterations {early}")
    if not (full64[0] < GBA_F64_GAP[0] and full64[1] < GBA_F64_GAP[1] and full64[2] <= GBA_F64_GAP[2]):
        raise AssertionError(f"global BA {name}: float64 card vs CPU {full64}")


def _rodrigues(w):
    """The rotation matrix of the rotation vector `w` (radians)."""
    th = np.linalg.norm(w)
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1.0 - np.cos(th)) / th ** 2 * K @ K


def run_batch_lost(device, card, card_seqs) -> dict:
    """`BatchTracker(tum3_config(), 2)` with its defaults over orbits 0 and
    1, sequence 1 blank (gray 120, zero depth) at frames 6 and 7: the LOST
    sequence is stepped from its motion model inside the batch. The frames
    are the port's renders on the CPU, the inputs of the JAX reference
    (`batch_reference_jax.py --config lost --port-renders`); their gaps to
    the card's renders of the same orbits (`card_seqs`) are printed. The
    launch counts are reset just before and read just after. Gates: the
    LOST frames of the JAX package's batch; a LOST frame reports the last
    tracked pose unchanged, as there; sequence 1's tracked poses within
    BATCH_LOST_TRACK_GAP of the JAX package's at frames 0-7 (up to the loss
    and through it; the gaps at the recovery, frame 8, and the three frames
    after it are printed); every local BA run of sequence 1 solved again on
    the CPU from the captured problem (check_ba); each sequence's ATE
    within BATCH_LOST_ATE_REL of JAX's both ways, sequence 0's also <=
    0.02 m. Returns the launch counts."""
    from hfvo_tpu_torch.config import tum3_config
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.parallel.multiseq import BatchTracker
    from hfvo_tpu_torch.testing import synthetic
    from hfvo_tpu_torch.tracking.tracker import _gray_u8

    seqs = {q: synthetic.render_sequence(n=N_FRAMES, seed=q) for q in BATCH_LOST_SEQS}
    gray_gap = max(float(np.abs(a - b).max()) for q in BATCH_LOST_SEQS for a, b in zip(seqs[q][1], card_seqs[q][1]))
    u8_diff = sum(int((_gray_u8(a) != _gray_u8(b)).sum()) for q in BATCH_LOST_SEQS
                  for a, b in zip(seqs[q][1], card_seqs[q][1]))
    depth_gap = max(float(np.abs(a - b).max()) for q in BATCH_LOST_SEQS for a, b in zip(seqs[q][2], card_seqs[q][2]))
    log(f"batch_lost: the CPU's renders against the card's: gray {gray_gap:.6f} levels at most, {u8_diff} pixels "
        f"apart as uint8 over {len(BATCH_LOST_SEQS) * N_FRAMES} frames, depth {depth_gap:.3e} m at most")
    cfg = tum3_config()
    bt = BatchTracker(cfg, len(BATCH_LOST_SEQS), device)
    logs = [keyframe_path_log(tr) for tr in bt.trackers]
    blank = set(BATCH_LOST_BLANK)
    reset_counts()
    lost, secs, tracked = [[] for _ in BATCH_LOST_SEQS], [], []
    for i in range(N_FRAMES):
        gd = [_blank(seqs[q][1][i], seqs[q][2][i]) if (j, i) in blank else (seqs[q][1][i], seqs[q][2][i])
              for j, q in enumerate(BATCH_LOST_SEQS)]
        inits = [np.linalg.inv(seqs[q][0][0]) for q in BATCH_LOST_SEQS] if i == 0 else None
        t0 = time.perf_counter()
        res = bt.track_batch([g for g, _ in gd], [d for _, d in gd], inits)
        secs.append(time.perf_counter() - t0)
        tracked.append(np.asarray(res[1].T_cw))
        for j, r in enumerate(res):
            if r.state.name != "OK":
                lost[j].append(i)
    torch.cuda.synchronize()
    launches = read_counts()
    S, steps = len(BATCH_LOST_SEQS), N_FRAMES - 1
    want = {"fast_score_dual": S, "fast_score_dual_batched": steps, "fast_score": 0, "fast_score_batched": 0,
            "hough_vote": S, "hough_vote_batched": steps}
    ts = np.arange(N_FRAMES) / 30.0
    ates = [float(evaluate.ate(ts, seqs[q][0], ts, est, align="origin").rmse)
            for q, est in zip(BATCH_LOST_SEQS, bt.get_trajectories())]
    gates = [((1 - BATCH_LOST_ATE_REL) * j, (1 + BATCH_LOST_ATE_REL) * j) for j in JAX_BATCH_LOST_ATE_M]
    gates[0] = (gates[0][0], min(gates[0][1], 0.02))
    ms = np.array(secs[1:]) * 1e3
    gaps = []
    for i, row in enumerate(JAX_BATCH_LOST_SEQ1_TRACKED):
        T_jax = np.eye(4)
        T_jax[:3, :3], T_jax[:3, 3] = _rodrigues(np.array(row[:3])), row[3:]
        gaps.append(pose_gap(tracked[i].astype(np.float64), T_jax))
    held = all(np.array_equal(tracked[i], tracked[i - 1]) for i in lost[1])
    log(f"batch_lost ({card}): LOST frames {lost} (JAX {list(map(list, JAX_BATCH_LOST_LOST_FRAMES))}), ATE "
        f"{ates} m (gates {list(gates)}, JAX {list(JAX_BATCH_LOST_ATE_M)}), ms a call median {np.median(ms):.3f} "
        f"p90 {np.percentile(ms, 90):.3f}; launches {launches}; keyframes "
        f"{[tr.vomap.kf_order_counter for tr in bt.trackers]}, local BA runs {[len(lg['ba']) for lg in logs]}")
    log("batch_lost seq 1 tracked pose vs JAX's, frames 0-11: "
        + ", ".join(f"{i}: {1e3 * g[0]:.3f} mm {g[1]:.4f} deg" for i, g in enumerate(gaps)))
    if launches != want:
        raise AssertionError(f"batch_lost: launches {launches}, want {want}")
    if [tuple(x) for x in lost] != list(JAX_BATCH_LOST_LOST_FRAMES) or not all(
            lo <= a <= hi for a, (lo, hi) in zip(ates, gates)):
        raise AssertionError(f"batch_lost: LOST frames {lost}, ATE {ates}")
    if not held:
        raise AssertionError("batch_lost: a LOST frame did not report the last tracked pose")
    if not all(g[0] < BATCH_LOST_TRACK_GAP[0] and g[1] < BATCH_LOST_TRACK_GAP[1] for g in gaps[:8]):
        raise AssertionError(f"batch_lost: sequence 1's tracked poses part from JAX's at frames 0-7: {gaps[:8]}")
    check_ba("batch_lost seq 1", [logs[1]], cfg.camera, n_cpu=2 * len(logs[1]["ba"]))
    return launches


# ---- facade and IO phases ---------------------------------------------------


def _expect_launches(name, launches, min_inits, min_steps, lines=True, exact=False) -> None:
    """Launch counts of a tracking phase: K1 at least once per single-frame
    extraction (`min_inits`: initializations), K1b once per fused step
    (`min_steps` of them at least, exactly with `exact`), K3 and K3b as K1
    and K1b's line-detecting calls (relocalizations extract without lines),
    K2 and K2b not at all."""
    n_b = launches["fast_score_dual_batched"]
    ok = (launches["fast_score_dual"] >= max(min_inits, 1)
          and (n_b == min_steps if exact else n_b >= max(min_steps, 1))
          and launches["fast_score"] == 0 and launches["fast_score_batched"] == 0)
    if lines:
        ok &= (1 <= launches["hough_vote"] <= launches["fast_score_dual"]
               and launches["hough_vote_batched"] == launches["fast_score_dual_batched"])
    if not ok:
        raise AssertionError(f"{name}: launches {launches}, want at least {min_inits} single-frame and "
                             f"{min_steps} batched extractions")


def _steps(trackers):
    """Fused steps the trackers ran through `_track_local_map` (track_rgbd,
    fallbacks, re-tracks), beside their pipelined dispatches."""
    return sum(tr.stage_times.get("fused_step", [0, 0])[1] for tr in trackers)


def _cli_frames():
    """The cli phase's frames: test_cli_e2e.py's protocol (orbit seed 11)
    rendered on the CPU, and frame 16 beyond the file's 16 frames."""
    from hfvo_tpu_torch.testing import synthetic

    return synthetic.render_sequence(n=CLI_FRAMES + 1, seed=11)


def _quiet(fn, *a, **kw):
    """fn's return value and what it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def run_cli(device, card, workdir) -> dict:
    """`python -m hfvo_tpu_torch.cli` on the card over a TUM directory of
    test_cli_e2e.py's protocol (16 frames of the port's CPU renders: RGB
    PNGs of the uint8 gray, 16-bit depth PNGs, association file, settings),
    with `--kf-out --ply --checkpoint-out`, natively where the native loader
    builds (it needs libpng's headers) and with `--loader python`; launch
    counts reset before the Python loader's run and read after it. Gates:
    each run's ATE < 0.03 m and <= 1.5x the JAX CLI's on the same files;
    eval_cli's printed APE equal to evaluate.ate's; the checkpoint loads
    into a fresh tracker on the card and on the CPU, and both track frame 16
    within 2 mm / 0.1 deg."""
    import os

    from hfvo_tpu_torch import cli, eval_cli, native
    from hfvo_tpu_torch.io import evaluate, trajectory, tum
    from hfvo_tpu_torch.io.yaml_config import config_from_yaml
    from hfvo_tpu_torch.testing import synthetic
    from hfvo_tpu_torch.tracking.tracker import Tracker, TrackState
    from hfvo_tpu_torch.vomap.checkpoint import load_checkpoint

    T_wc, grays, depths = _cli_frames()
    d = os.path.join(workdir, "tum")
    synthetic.write_tum_sequence(d, grays[:CLI_FRAMES], depths[:CLI_FRAMES], CLI_SETTINGS)
    settings, assoc = os.path.join(d, "settings.yaml"), os.path.join(d, "assoc.txt")
    gt = os.path.join(workdir, "gt.txt")
    trajectory.save_tum(gt, np.arange(CLI_FRAMES) / 30.0, T_wc[:CLI_FRAMES])
    if native.native_available():
        loaders = ["native", "python"]
    else:
        log(f"cli: native loader unavailable, build error: {native.build_error().strip().splitlines()[-1]}")
        loaders = ["python"]
    out, launches, fps = {}, None, {}
    for loader in loaders:
        paths = {k: os.path.join(workdir, f"{loader}_{k}") for k in ("traj.txt", "kf.txt", "map.ply", "map.npz")}
        argv = [settings, d, assoc, "--loader", loader, "--out", paths["traj.txt"], "--kf-out", paths["kf.txt"],
                "--ply", paths["map.ply"], "--checkpoint-out", paths["map.npz"], "--device", str(device)]
        if loader == "python":
            reset_counts()
        t0 = time.perf_counter()
        rc, printed = _quiet(cli.main, argv)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        if loader == "python":
            launches = read_counts()
        if rc != 0:
            raise AssertionError(f"cli ({loader}): exit code {rc}")
        ts, T_est = trajectory.load_tum(paths["traj.txt"])
        ate = float(evaluate.ate(np.arange(CLI_FRAMES) / 30.0, T_wc[:CLI_FRAMES], np.asarray(ts),
                                 np.asarray(T_est), align="origin").rmse)
        fps[loader] = [ln for ln in printed.splitlines() if ln.startswith("processed")][0]
        n_kf = len(trajectory.load_tum(paths["kf.txt"])[0])
        log(f"cli ({card}), --loader {loader}: {fps[loader]}; wall {wall:.3f} s with the system's set-up; ATE RMSE "
            f"{ate:.6f} m (JAX CLI {JAX_CLI_ATE_M:.6f}, gate < {min(CLI_ATE_GATE_M, 1.5 * JAX_CLI_ATE_M):.6f}); "
            f"{n_kf} keyframes saved")
        if len(ts) != CLI_FRAMES or not ate < min(CLI_ATE_GATE_M, 1.5 * JAX_CLI_ATE_M):
            raise AssertionError(f"cli ({loader}): {len(ts)} frames, ATE {ate}")
        out[loader] = (np.asarray(T_est), paths, ate)
    log(f"cli: loader that ran on this card: {', '.join(loaders)}")
    # The cli's system: one initialization and 15 fused steps.
    _expect_launches("cli", launches, 1, CLI_FRAMES - 1)
    if "native" in out:
        # No gate between the two: on RGB PNGs the native loader's float
        # BT.601 luma puts 13 of the 256 gray levels a hair under the
        # integer (37 -> 36.999996), which the tracked frames' uint8 cast
        # truncates, while PIL's integer luma is exact; the JAX package's
        # two CLI runs part the same way (ATE 0.011644 against 0.011551 m).
        gap = float(np.abs(out["native"][0][:, :3, 3] - out["python"][0][:, :3, 3]).max())
        log(f"cli: native vs python loader trajectories within {gap * 1e3:.4f} mm (RGB PNGs: the loaders' "
            f"lumas differ, each run is gated on its ATE)")
    T_est, paths, ate = out["python"]
    printed = _quiet(eval_cli.main, [gt, paths["traj.txt"]])[1]
    want = f"APE rmse {ate * 100:.2f} cm"
    log(f"cli: eval_cli printed: {printed.strip()}")
    if want not in printed:
        raise AssertionError(f"cli: eval_cli printed {printed!r}, want {want!r}")
    # The checkpoint resumes on the card and on the CPU: frame 16.
    cfg = config_from_yaml(settings)
    g16 = grays[CLI_FRAMES]
    d16 = np.clip(depths[CLI_FRAMES] * 5000.0, 0, 65535).astype(np.uint16).astype(np.float32) / 5000.0
    res = {}
    for dev in (device, "cpu"):
        tr = Tracker(cfg, dev)
        load_checkpoint(paths["map.npz"], tr)
        res[str(dev)] = tr.track_rgbd(g16, d16)
    a, b = res[str(device)], res["cpu"]
    dt, dr = pose_gap(a.T_cw, b.T_cw)
    # The CLI's system starts at the identity: the truth in frame 0's frame.
    truth = np.linalg.inv(T_wc[0]) @ T_wc[CLI_FRAMES]
    err = float(np.linalg.norm(np.linalg.inv(a.T_cw)[:3, 3] - truth[:3, 3]))
    log(f"cli: checkpoint resumed, frame {CLI_FRAMES}: {a.state.name} / {b.state.name}, card vs CPU "
        f"{dt * 1e3:.4f} mm {dr:.5f} deg, {a.n_matches} vs {b.n_matches} matches, {err * 1e3:.3f} mm from the truth")
    if a.state is not TrackState.OK or b.state is not TrackState.OK or not (dt < CPU_GAP_M and dr < CPU_GAP_DEG):
        raise AssertionError("cli: the resumed trackers part")
    return dict(launches=launches, trajectory=T_est, frames=(T_wc, grays, depths), dir=d)


def run_stream(device, card, cli_out, workdir) -> dict:
    """`hfvo_tpu_torch.stream_cli` on the card, fed the cli phase's 16 frames
    (decoded as the Python loader decodes them, depth as the PNGs' uint16)
    over localhost by a publisher thread; launch counts reset just before
    and read just after. Gates: all 16 emitted, none dropped, the saved
    trajectory within CPU_GAP_M (2 mm) of the cli phase's: the same frames
    reach the same system, but two runs on the card part by the rounding
    of scatter-adds with no fixed order (two CLI runs of these frames on an
    H100 parted by 0.46-1.00 mm)."""
    import os
    import socket
    import threading

    from hfvo_tpu_torch import stream_cli
    from hfvo_tpu_torch.io import stream, trajectory, tum
    from PIL import Image

    d = cli_out["dir"]
    frames = list(tum.iterate_sequence(d, os.path.join(d, "assoc.txt"), 5000.0))
    servers = []
    plain = stream.FrameStreamServer

    class Recorded(plain):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    stream.FrameStreamServer = Recorded
    ready = threading.Event()
    port, rc = [], {}
    out = os.path.join(workdir, "stream_traj.txt")

    def serve():
        rc["rc"], rc["printed"] = _quiet(stream_cli.main, [
            os.path.join(d, "settings.yaml"), "--kf-out", os.path.join(workdir, "stream_kf.txt"), "--out", out,
            "--device", str(device)], listening=lambda p: (port.append(p), ready.set()))

    reset_counts()
    t0 = time.perf_counter()
    th = threading.Thread(target=serve, daemon=True)
    try:
        th.start()
        if not ready.wait(timeout=300):
            raise AssertionError("stream: the server never listened")
        t1 = time.perf_counter()
        with socket.create_connection(("127.0.0.1", port[0]), timeout=120) as sock:
            for ts, g, _ in frames:
                depth_png = np.asarray(Image.open(os.path.join(d, "depth", f"{ts:.6f}.png")))
                stream.send_frame(sock, stream.CH_RGB, ts, g.astype(np.uint8))
                stream.send_frame(sock, stream.CH_DEPTH, ts + 0.002, depth_png)
            stream.send_frame(sock, stream.CH_EOF, 0.0, None)
        th.join(timeout=600)
    finally:
        stream.FrameStreamServer = plain
    wall = time.perf_counter() - t1
    torch.cuda.synchronize()
    launches = read_counts()
    if th.is_alive() or rc.get("rc") != 0:
        raise AssertionError(f"stream: stream_cli did not finish ({rc})")
    sync = servers[0].sync
    ts, T_est = trajectory.load_tum(out)
    gap = float(np.abs(np.asarray(T_est)[:, :3, 3] - cli_out["trajectory"][:, :3, 3]).max()) \
        if len(ts) == CLI_FRAMES else float("inf")
    log(f"stream ({card}): {sync.n_emitted} emitted, {sync.n_dropped} dropped; {wall / CLI_FRAMES * 1e3:.3f} ms a "
        f"frame from the first send to the end (set-up {t1 - t0:.3f} s); trajectory within {gap * 1e3:.4f} mm of "
        f"the cli phase's (gate {CPU_GAP_M * 1e3:.1f} mm); "
        f"launches {launches}")
    if sync.n_emitted != CLI_FRAMES or sync.n_dropped or not gap < CPU_GAP_M:
        raise AssertionError("stream: frames lost or poses apart from the cli phase's")
    _expect_launches("stream", launches, 1, CLI_FRAMES - 1)
    return dict(launches=launches, ms=wall / CLI_FRAMES * 1e3)


class _PinnedCheck:
    """Wraps the tracker module's `_queue_step` and `collect_fused_step`:
    keeps each launched step's device outputs and, at its collect, pulls
    them again with a blocking `.cpu()` and requires them bit-equal to what
    the pinned non-blocking copies delivered."""

    def __init__(self, trk):
        self.trk, self.plain = trk, (trk._queue_step, trk.collect_fused_step)
        self.dev, self.n = {}, 0  # id of a step's device poses -> its device outputs

    def __enter__(self):
        queue_plain, collect_plain = self.plain

        def queue(*a, **kw):
            out = queue_plain(*a, **kw)
            self.dev[id(out[3])] = out[0]
            return out

        def collect(step):
            out = collect_plain(step)
            bits = lambda t: t.contiguous().reshape(-1).view(torch.uint8)  # noqa: E731 (NaN-safe)
            dev = self.dev.pop(id(step.T_cw))
            if len(dev) != len(step.host):
                raise AssertionError("async: a step's host copies do not match its outputs")
            for dev_t, host_t in zip(dev, step.host):
                if not torch.equal(bits(dev_t.cpu()), bits(host_t)):
                    raise AssertionError("async: a pinned host copy differs from its device tensor")
            self.n += 1
            return out

        self.trk._queue_step, self.trk.collect_fused_step = queue, collect
        return self

    def __exit__(self, *exc):
        self.trk._queue_step, self.trk.collect_fused_step = self.plain


class _SyncCount:
    """Wraps the tracker module's `launch_fused_step` and counts, per call,
    the host synchronizations that `torch.cuda.set_sync_debug_mode` reports
    inside it."""

    def __init__(self, trk):
        self.trk, self.plain, self.counts = trk, trk.launch_fused_step, []

    def __enter__(self):
        import warnings

        def launch(*a, **kw):
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode(1)
                try:
                    out = self.plain(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            self.counts.append(sum("synchroniz" in str(w.message) for w in got))
            return out

        self.trk.launch_fused_step = launch
        return self

    def __exit__(self, *exc):
        self.trk.launch_fused_step = self.plain


def _track_async(tracker, grays, depths, T0, n):
    results = []
    for i in range(n):
        results.extend(tracker.track_rgbd_async(grays[i], depths[i], T_cw_init=T0))
    results.extend(tracker.flush())
    return results


def run_async(device, card, frames, default_ate, fps_frames) -> dict:
    """`Tracker.track_rgbd_async` of the default system (`tum3_config()`,
    every default) on the card over the 25-frame orbit at depth 1 and at
    depth 24 with resolve_burst 12 (bench.py's setting); each run's launch
    counts reset just before and read just after, and every collect's
    pinned host copies checked bit-equal against a blocking pull. Gates
    (tests/test_async_tracking.py): as many results as frames, 0 LOST, ATE
    < max(2x the same call's track_rgbd ATE, 0.02 m); the poisoned-dispatch
    protocol (12 frames, frame 6 blank, auto_reset off): the last state OK
    and the final position within 0.08 m. Then frames/s over a window as
    bench.py measures it (the pipe filled before the timer, flushed after
    it) at depth 1 and depth 24 beside track_rgbd's on the same frames, the
    step_times medians, and the host synchronizations in one dispatch."""
    from hfvo_tpu_torch.config import tum3_config
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.tracking import tracker as trk
    from hfvo_tpu_torch.tracking.tracker import Tracker, TrackState

    T_wc, grays, depths = frames
    T0 = np.linalg.inv(T_wc[0])
    ts = np.arange(N_FRAMES) / 30.0
    gate = max(2 * default_ate, 0.02)
    out = {}
    for depth, burst in ASYNC_DEPTHS:
        tr = Tracker(tum3_config(), device, pipeline_depth=depth, resolve_burst=burst)
        reset_counts()
        with _PinnedCheck(trk) as pin:
            results = _track_async(tr, grays, depths, T0, N_FRAMES)
        torch.cuda.synchronize()
        launches = read_counts()
        _expect_launches(f"async depth {depth}", launches, 1, _steps([tr]) + len(tr.step_times["dispatch"]),
                         exact=True)
        est = tr.get_trajectory()
        ate = float(evaluate.ate(ts, T_wc, ts, est, align="origin").rmse)
        n_lost = sum(r.state is not TrackState.OK for r in results)
        log(f"async depth {depth} burst {burst} ({card}): {len(results)} results, LOST {n_lost}, ATE RMSE "
            f"{ate:.6f} m (track_rgbd {default_ate:.6f}, gate < {gate:.6f}); {pin.n} collects with the pinned "
            f"copies bit-equal to a blocking pull; launches {launches}")
        if len(results) != N_FRAMES or n_lost or not ate < gate or pin.n == 0:
            raise AssertionError(f"async depth {depth}: fails its gates")
        out[f"async_d{depth}"] = launches
    # The poisoned dispatch.
    tr = Tracker(tum3_config(), device, use_local_ba=False, use_loop_closing=False, auto_reset=False)
    g12, d12 = list(grays[:12]), list(depths[:12])
    g12[6], d12[6] = np.zeros_like(g12[6]), np.zeros_like(d12[6])
    reset_counts()
    results = _track_async(tr, g12, d12, T0, 12)
    launches = read_counts()
    err = float(np.linalg.norm(tr.get_trajectory()[-1][:3, 3] - T_wc[11][:3, 3]))
    log(f"async poisoned: {len(results)} results, states {[r.state.name for r in results]}, final position "
        f"error {err * 1e3:.3f} mm (gate 80 mm); launches {launches}")
    if len(results) != 12 or results[-1].state is not TrackState.OK or not err < 0.08:
        raise AssertionError("async poisoned: fails its gates")
    out["async_poisoned"] = launches
    # Frames/s over a window (bench.py:104-135), the default system: the
    # pipe filled to its depth before the timer and flushed after it, so
    # that it is equally full at both ends of the window.
    Tf, gf, df = fps_frames
    n_warm, win = ASYNC_FPS_WARM, ASYNC_FPS_WINDOW
    rates = {}
    for mode, depth, burst in (("track_rgbd", 0, 0), *(("async", d, b) for d, b in ASYNC_DEPTHS),
                               ("track_rgbd", 0, 0)):
        tr = Tracker(tum3_config(), device, pipeline_depth=max(depth, 1), resolve_burst=burst)
        for i in range(n_warm):
            tr.track_rgbd(gf[i], df[i], T_cw_init=np.linalg.inv(Tf[0]))
        if mode == "track_rgbd":
            t0 = time.perf_counter()
            for i in range(n_warm, n_warm + win):
                tr.track_rgbd(gf[i], df[i])
            rate = win / (time.perf_counter() - t0)
        else:
            for i in range(n_warm, n_warm + depth):
                tr.track_rgbd_async(gf[i], df[i])
            in_flight = [len(tr._pipe)]
            for v in tr.step_times.values():
                v.clear()
            with _SyncCount(trk) as syncs:
                t0 = time.perf_counter()
                for i in range(n_warm + depth, n_warm + depth + win):
                    tr.track_rgbd_async(gf[i], df[i])
                rate = win / (time.perf_counter() - t0)
            in_flight.append(len(tr._pipe))
            tr.flush()
            med = {k: float(np.median(v) * 1e3) if v else None for k, v in tr.step_times.items()}
            mean = {k: float(np.mean(v) * 1e3) if v else None for k, v in tr.step_times.items()}
            log(f"async depth {depth}: frames in flight at the window's start and end {in_flight}; "
                f"step_times medians (ms) {json.dumps(med)}, means {json.dumps(mean)}; host synchronizations a "
                f"dispatch median {statistics.median(syncs.counts)} (min {min(syncs.counts)}, max "
                f"{max(syncs.counts)}) over {len(syncs.counts)} dispatches")
            out[f"syncs_d{depth}"] = statistics.median(syncs.counts)
        key = mode if mode == "track_rgbd" else f"async_d{depth}"
        rates.setdefault(key, []).append(rate)
    log(f"async frames/s ({card}), the default system over a window of {win} frames (the pipe filled to its "
        f"depth before it) of a {len(gf)}-frame orbit: "
        + ", ".join(f"{k} {' / '.join(f'{r:.3f}' for r in v)}" for k, v in rates.items()))
    return out


def run_batch_async(device, card, seqs, batch_ref) -> dict:
    """`BatchTracker(tum3_config(), 8)` (local BA on) with
    `track_batch_async` over the 8 orbits at depths 1 and 2; each run's
    launch counts reset just before and read just after. Gates: as many
    results as frames, and each sequence's ATE < max(2x its ATE in this
    call's batch_ba phase (track_batch), 0.02 m); where the JAX package's
    own pipelined batch misses that gate on the orbit at that depth
    (against its own track_batch, `JAX_BATCH_BA_ATE_M`), the sequence is
    held to < min(1.25x the JAX package's ATE there, 0.03 m) instead
    (`JAX_BATCH_ASYNC_ATE_M`). Frames/s beside track_batch's in the same
    call."""
    from hfvo_tpu_torch.config import tum3_config
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.parallel.multiseq import BatchTracker

    ts = np.arange(N_FRAMES) / 30.0
    out = {}
    for depth in (1, 2):
        bt = BatchTracker(tum3_config(), N_SEQ, device, pipeline_depth=depth)
        bt.warmup()
        reset_counts()
        n_res = len(bt.track_batch([q[1][0] for q in seqs], [q[2][0] for q in seqs],
                                   [np.linalg.inv(q[0][0]) for q in seqs]))
        t0 = time.perf_counter()
        for i in range(1, N_FRAMES):
            n_res += len(bt.track_batch_async([q[1][i] for q in seqs], [q[2][i] for q in seqs]))
        n_res += len(bt.flush())
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_counts()
        _expect_launches(f"batch_async depth {depth}", launches, N_SEQ,
                         len(bt.step_times["dispatch"]) + _steps(bt.trackers))
        fps = N_SEQ * (N_FRAMES - 1) / wall
        failed = []
        msg = []
        for s, (tr, q) in enumerate(zip(bt.trackers, seqs)):
            ate = float(evaluate.ate(ts, q[0], ts, tr.get_trajectory(), align="origin").rmse)
            msg.append(f"{ate:.6f}")
            if ate < max(2 * batch_ref["ate"][s], 0.02):
                continue
            jax_ate = JAX_BATCH_ASYNC_ATE_M[depth][s]
            jax_misses = not jax_ate < max(2 * JAX_BATCH_BA_ATE_M[s], 0.02)
            gate = min(1.25 * jax_ate, 0.03)
            log(f"batch_async depth {depth} seq {s}: ATE {ate:.6f} m, not < max(2x track_batch's, 0.02 m); the "
                f"JAX package's pipelined batch there: {jax_ate:.6f} m, "
                + (f"which misses that gate itself: held to < {gate:.6f} m" if jax_misses else "which meets it"))
            if not (jax_misses and ate < gate):
                failed.append(s)
        log(f"batch_async depth {depth} ({card}): {n_res} results, ATE per sequence {msg} (track_batch "
            f"{[f'{a:.6f}' for a in batch_ref['ate']]}; JAX pipelined batch "
            f"{[f'{a:.6f}' for a in JAX_BATCH_ASYNC_ATE_M[depth]]}); {fps:.3f} frames/s across the {N_SEQ} "
            f"sequences beside track_batch's {batch_ref['fps']:.3f} in this call; step_times medians (ms) "
            f"{json.dumps({k: float(np.median(v) * 1e3) for k, v in bt.step_times.items() if v})}; launches {launches}")
        if n_res != N_SEQ * N_FRAMES or failed:
            raise AssertionError(f"batch_async depth {depth}: {n_res} results, sequences {failed} fail")
        out[f"batch_async_d{depth}"] = launches
    return out


def run_endurance(device, card) -> dict:
    """Both protocols of tests/test_endurance.py on the card
    (`hfvo_tpu_torch.testing.endurance`), each with its launch counts reset
    just before and read just after, and with the test's gates; the JAX
    package's CPU numbers on the port's renders beside them
    (`full_reference_jax.py --config endurance`)."""
    from hfvo_tpu_torch.testing import endurance

    out = {}
    reset_counts()
    r = endurance.points_past_kf_capacity(device)
    torch.cuda.synchronize()
    out["endurance_points"] = read_counts()
    log(f"endurance points ({card}): {json.dumps(r)}; JAX on the CPU: {json.dumps(JAX_ENDURANCE['points'])}; "
        f"launches {out['endurance_points']}")
    if not endurance.points_past_kf_capacity_ok(r):
        raise AssertionError("endurance points: fails the gates of test_endurance_past_kf_capacity")
    reset_counts()
    r = endurance.full_stack_300(device)
    torch.cuda.synchronize()
    out["endurance_full"] = read_counts()
    log(f"endurance full stack ({card}): {json.dumps(r)}; JAX on the CPU: {json.dumps(JAX_ENDURANCE['full'])}; "
        f"launches {out['endurance_full']}")
    if not endurance.full_stack_300_ok(r):
        raise AssertionError("endurance full stack: fails the gates of test_endurance_full_stack_300")
    _expect_launches("endurance points", out["endurance_points"], 1, 319, lines=False)
    _expect_launches("endurance full stack", out["endurance_full"], 1, 299)
    return out


# The leftovers phase (run_leftovers): tests/test_lk.py's protocols and
# tests/test_sym_eig.py's damped 6x6 blocks.
LK_SHIFT = (6.0, -4.0)
LK_CARD_CPU_PX = 1e-2
INV6_REL_ERR = 1e-4


def _lk_textured(rng, device, h=240, w=320):
    """tests/test_lk.py's textured frame: uniform noise at 1/8 resolution,
    cubic-upsampled (the port's `jax.image.resize` counterpart)."""
    from hfvo_tpu_torch.ops import image

    base = torch.from_numpy(rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32))
    return image.resize(base, (h, w), "cubic").to(device)


def _timed_ms(fn, reps: int = 5) -> float:
    """Median wall ms of fn() with the device synchronized, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def run_leftovers(device, card) -> dict:
    """The JAX package's functions that no path calls, on the card against
    the same calls on the CPU: `pyr_lk` on tests/test_lk.py's translation
    protocol (median flow within 0.3 px of (6, -4), ok share above 0.8,
    card and CPU within LK_CARD_CPU_PX where both say ok) and its
    unrelated-frame protocol (ok share below 0.5); `recover_line_by_flow`
    on its rendered 0.03 rad yaw (ok, within 3 px of a line detected in the
    next frame); `binarize_band_desc` of that frame's band descriptors
    (bit-equal to the CPU); `inv6x6_blocked` on tests/test_sym_eig.py's
    damped blocks against a float64 inverse (relative error <=
    INV6_REL_ERR). None of them launches a kernel."""
    from hfvo_tpu_torch.config import tum3_config
    from hfvo_tpu_torch.geometry import se3
    from hfvo_tpu_torch.ops import lines, lk, sym_eig
    from hfvo_tpu_torch.testing import synthetic

    cpu = torch.device("cpu")
    out = {}
    rng = np.random.default_rng(0)
    img0 = _lk_textured(rng, device)
    p0 = torch.from_numpy(rng.uniform([40, 40], [280, 200], size=(50, 2)).astype(np.float32)).to(device)
    img1 = torch.roll(img0, (-4, 6), dims=(0, 1))
    other = _lk_textured(np.random.default_rng(99), device)
    intr = tum3_config().camera
    scene = synthetic.make_room(0, device=device)
    T0 = torch.eye(4, device=device)
    T0[2, 3] = -0.8
    R = se3.exp_so3(torch.tensor([0.0, 0.03, 0.0], device=device))
    T1 = T0.clone()
    T1[:3, :3] = T0[:3, :3] @ R
    g0, g1 = synthetic.render(scene, intr, T0)[0], synthetic.render(scene, intr, T1)[0]
    lf0 = lines.detect_lines(g0)
    i = int(torch.argmax(torch.where(lf0.valid, lf0.length, torch.zeros((), device=device))))
    line_args = (intr, g0, g1, lf0.p0[i], lf0.p1[i], R.T.contiguous())
    rng = np.random.default_rng(0)
    rng.normal(size=(64, 3, 3))  # tests/test_sym_eig.py draws its 3x3 blocks first
    B = rng.normal(size=(32, 6, 6)).astype(np.float32)
    B = (B @ B.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    Bd = torch.from_numpy(B).to(device)

    reset_counts()
    p1, ok = lk.pyr_lk(img0, img1, p0, p0)
    _, ok_other = lk.pyr_lk(img0, other, p0[:30], p0[:30])
    q0, q1, line_ok = lk.recover_line_by_flow(*line_args)
    words = lines.binarize_band_desc(lf0.desc)
    inv = sym_eig.inv6x6_blocked(Bd)
    torch.cuda.synchronize()
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"leftovers: a kernel launched: {launches}")

    p1c, okc = lk.pyr_lk(*(x.to(cpu) for x in (img0, img1, p0, p0)))
    both = ok.cpu() & okc
    flow = (p1 - p0)[ok].median(dim=0).values.cpu().numpy()
    out["pyr_lk"] = {
        "ok_share": float(ok.float().mean()), "median_flow": flow.tolist(),
        "card_cpu_px": float((p1.cpu() - p1c)[both].abs().max()), "ok_equal": bool((ok.cpu() == okc).all()),
        "unrelated_ok_share": float(ok_other.float().mean()),
    }
    if not (out["pyr_lk"]["ok_share"] > 0.8 and np.abs(flow - LK_SHIFT).max() <= 0.3
            and out["pyr_lk"]["card_cpu_px"] <= LK_CARD_CPU_PX and out["pyr_lk"]["unrelated_ok_share"] < 0.5):
        raise AssertionError(f"leftovers: pyr_lk fails tests/test_lk.py's gates: {out['pyr_lk']}")

    lf1 = lines.detect_lines(g1)
    v1 = lf1.valid
    a1, b1 = lf1.p0[v1], lf1.p1[v1]
    d = b1 - a1
    n = torch.stack([-d[:, 1], d[:, 0]], 1)
    n = n / (torch.linalg.norm(n, dim=1, keepdim=True) + 1e-9)
    perp = torch.abs((n * (0.5 * (q0 + q1) - a1)).sum(1)).min()
    qc0, qc1, okc_line = lk.recover_line_by_flow(intr, *(x.to(cpu) for x in line_args[1:]))
    out["recover_line_by_flow"] = {
        "ok": bool(line_ok), "px_to_detected": float(perp), "ok_cpu": bool(okc_line),
        "card_cpu_px": float(torch.maximum((q0.cpu() - qc0).abs().max(), (q1.cpu() - qc1).abs().max())),
    }
    if not (bool(line_ok) and float(perp) < 3.0):
        raise AssertionError(f"leftovers: recover_line_by_flow fails its gates: {out['recover_line_by_flow']}")

    words_cpu = lines.binarize_band_desc(lf0.desc.cpu())
    out["binarize_band_desc"] = {"rows": int(words.shape[0]), "bit_equal": bool(torch.equal(words.cpu(), words_cpu))}
    if not out["binarize_band_desc"]["bit_equal"]:
        raise AssertionError("leftovers: binarize_band_desc on the card differs from the CPU")

    ref = np.linalg.inv(B.astype(np.float64))
    got = inv.cpu().numpy().astype(np.float64)
    rel = float((np.linalg.norm(got - ref, axis=(1, 2)) / np.linalg.norm(ref, axis=(1, 2))).max())
    out["inv6x6_blocked"] = {"rel_err": rel}
    if not rel <= INV6_REL_ERR:
        raise AssertionError(f"leftovers: inv6x6_blocked relative error {rel} > {INV6_REL_ERR}")

    out["ms"] = {
        "pyr_lk_50": _timed_ms(lambda: lk.pyr_lk(img0, img1, p0, p0)),
        "recover_line_by_flow": _timed_ms(lambda: lk.recover_line_by_flow(*line_args)),
        "binarize_band_desc": _timed_ms(lambda: lines.binarize_band_desc(lf0.desc)),
        "inv6x6_blocked_32": _timed_ms(lambda: sym_eig.inv6x6_blocked(Bd)),
    }
    log(f"leftovers ({card}): {json.dumps(out)}")
    return out


# The adversarial phase (run_adversarial): the JAX suite's robustness
# protocols (hfvo_tpu_torch.testing.adversarial). The JAX package's numbers
# on the port's CPU renders of the same frames, from
# `JAX_PLATFORMS=cpu python3 full_reference_jax.py --config adversarial`:
JAX_ADVERSARIAL = {
    "slanted": {"ate_rmse_m": 0.005311, "lost": 0, "keyframes": 4, "n_ba_runs": 1},
    "distortion": {"ate_rmse_m": 0.011335, "lost": 0, "keyframes": 3, "n_ba_runs": 0},
    "noisy_depth": {"ate_rmse_m": 0.037438, "lost": 0, "keyframes": 3, "n_ba_runs": 0},
    "low_texture_slanted": {"ate_rmse_m": 0.039086, "lost": 0, "keyframes": 6, "n_ba_runs": 3},
    "icl": {"ate_rmse_m": 0.007029, "lost": 0, "keyframes": 2, "n_ba_runs": 0},
    "stride1": {"ate_rmse_m": 0.018729, "lost": 0, "keyframes": 3, "n_ba_runs": 0},
    "stride4": {"ate_rmse_m": 0.018694, "lost": 0, "keyframes": 3, "n_ba_runs": 0},
}
JAX_HOUGH_RECALL = (0.8333, 0.9167, 0.8333, 1.0000)
# A protocol's ATE may be at most this multiple of the JAX package's.
ADV_JAX_RATIO = 1.5


def run_adversarial(device, card) -> dict:
    """The robustness protocols of tests/test_adversarial.py (slanted quads
    and spheres, tum1 lens distortion, noisy depth with holes, low-texture
    slanted, ICL's negative fy), tests/test_depth_stride.py (strides 1 and
    4 from uint8 gray and uint16 depth) and the Hough recall protocol of
    tests/test_parity_deviations.py, at 640x480 with each preset's full
    caps, frames rendered on the card. Each protocol's launch counts are
    reset just before its run and read just after: K1 once per
    initialization and relocalization, K1b once per fused step, K3 and K3b
    alike, K2 and K2b never (K3 once per recall view). Gates: the JAX
    tests' own, each ATE at most ADV_JAX_RATIO x the JAX package's on the
    same renders. Returns the launches by protocol."""
    from hfvo_tpu_torch.testing import adversarial

    out, ates = {}, {}
    for name, (n, gate, test) in adversarial.PROTOCOLS.items():
        seq = adversarial.frames(name, device)
        reset_counts()
        rec = adversarial.track(name, seq, device)
        torch.cuda.synchronize()
        launches = out[f"adversarial_{name}"] = read_counts()
        ates[name] = rec["ate_rmse_m"]
        jax = JAX_ADVERSARIAL[name]
        log(f"adversarial {name} ({card}): {n} frames ({test}), ATE RMSE {rec['ate_rmse_m']:.6f} m (JAX "
            f"{jax['ate_rmse_m']:.6f}, gate {gate}), LOST {rec['lost']} (JAX {jax['lost']}), keyframes "
            f"{rec['keyframes']} (JAX {jax['keyframes']}), local BA runs {rec['n_ba_runs']} (JAX "
            f"{jax['n_ba_runs']}), final state {rec['state']}, launches {launches} ({rec['inits']} inits, "
            f"{rec['relocalizations']} relocalizations, {rec['steps']} fused steps), ms/tracked frame median "
            f"{rec['ms_median']:.3f} p90 {rec['ms_p90']:.3f}")
        want = {"fast_score_dual": rec["inits"] + rec["relocalizations"], "fast_score_dual_batched": rec["steps"],
                "fast_score": 0, "fast_score_batched": 0, "hough_vote": rec["inits"],
                "hough_vote_batched": rec["steps"]}
        bad = adversarial.failures(rec, ates.get("stride1"))
        if launches != want or rec["inits"] == 0 or rec["steps"] == 0:
            bad.append(f"launches {launches}, want {want}")
        if not rec["ate_rmse_m"] <= ADV_JAX_RATIO * jax["ate_rmse_m"]:
            bad.append(f"ATE {rec['ate_rmse_m']:.6f} m above {ADV_JAX_RATIO} x the JAX package's "
                       f"{jax['ate_rmse_m']:.6f}")
        if bad:
            raise AssertionError(f"adversarial {name}: " + "; ".join(bad))
    reset_counts()
    recalls = adversarial.hough_recall(device)
    torch.cuda.synchronize()
    launches = out["adversarial_hough_recall"] = read_counts()
    log(f"adversarial hough_recall ({card}): recall per view {[round(r, 4) for r in recalls]}, mean "
        f"{np.mean(recalls):.4f} min {min(recalls):.4f} (JAX on the same renders {list(JAX_HOUGH_RECALL)}); "
        f"launches {launches}")
    bad = adversarial.recall_failures(recalls)
    want = dict.fromkeys(KERNELS, 0) | {"hough_vote": len(recalls)}
    if launches != want:
        bad.append(f"launches {launches}, want {want}")
    if bad:
        raise AssertionError("adversarial hough_recall: " + "; ".join(bad))
    return out


def _sharded_batch_gaps(name, states, poses, ref_results, seqs) -> None:
    """A sharded (or 1-rank-mesh) batch over the first DIST_BATCH_FRAMES
    frames (state names and T_cw, (frame, seq)) against the unsharded
    batch_full run of the same orbits: every frame OK, positions within
    DIST_GAP_M, each orbit's ATE < 0.02 m."""
    from hfvo_tpu_torch.io import evaluate

    n = len(poses)
    T_wc = np.linalg.inv(np.asarray(poses, np.float64))
    ref_wc = np.linalg.inv(np.array([[r.T_cw for r in res] for res in ref_results[:n]], np.float64))
    gaps = np.linalg.norm(T_wc[..., :3, 3] - ref_wc[..., :3, 3], axis=-1)
    ts = np.arange(n) / 30.0
    ates = [float(evaluate.ate(ts, seqs[s][0][:n], ts, T_wc[:, s], align="origin").rmse) for s in range(N_SEQ)]
    states = {st for row in states for st in row}
    log(f"{name}: {N_SEQ} orbits x {n} frames, positions against the unsharded batch max {gaps.max() * 1e3:.4f} mm "
        f"(gate {DIST_GAP_M * 1e3} mm), ATE RMSE per orbit {[round(a, 6) for a in ates]} (gate 0.02 m), "
        f"states {sorted(states)}")
    if states != {"OK"} or not gaps.max() < DIST_GAP_M or not max(ates) < 0.02:
        raise AssertionError(f"{name}: the sharded batch departs from the unsharded one")


def run_distributed(device, card, seqs, batch_full_results, low_texture_log, low_texture_tracker) -> dict:
    """The distributed layer on the card (hfvo_tpu_torch/parallel/).

    (a) World 1 over NCCL in this process: `BatchTracker(tum3_config(), 8,
    mesh=<1-rank mesh>)` over the first DIST_BATCH_FRAMES frames of the batch
    phase's orbits against the batch_full run (the same configuration
    without a mesh), and the low-texture room with
    `LocalMapper(use_distributed=True)` (F1: on one rank every local BA run
    is the single-device solve) held to the low_texture phase's gates and
    printed beside its run. (b) DIST_WORLD spawned ranks on
    this GPU over gloo (`testing.dist_worker`; NCCL refuses two ranks on one
    device): the JAX package's dry run's five paths at n = 2
    (`dist_worker.dryrun_inputs`) with its gates, the sharded batch of the
    same 8 orbits (4 a rank) with K1b and K3b launched on each rank, and
    every local BA problem captured in the low-texture room's default run
    solved over the ranks against its single-device card solve. Returns the
    kernel launches of (a)'s batch."""
    import tempfile

    import torch.distributed as dist

    from hfvo_tpu_torch.bow.database import KeyFrameDatabase
    from hfvo_tpu_torch.config import tum3_config
    from hfvo_tpu_torch.geometry import se3
    from hfvo_tpu_torch.io import evaluate
    from hfvo_tpu_torch.parallel.mesh import init_process_group, make_mesh
    from hfvo_tpu_torch.parallel.multiseq import BatchTracker
    from hfvo_tpu_torch.testing import dist_worker, synthetic
    from hfvo_tpu_torch.tracking.tracker import Tracker

    n = DIST_BATCH_FRAMES
    cfg = tum3_config()
    ref = batch_full_results[:n]

    def frames(i):
        return [q[1][i] for q in seqs], [q[2][i] for q in seqs]

    # (a) One rank over NCCL.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        init_process_group(f"file://{d}/init", 1, 0, device)
        try:
            backend = dist.get_backend()
            mesh = make_mesh(n_edge=1, n_seq=1)
            reset_counts()
            bt = BatchTracker(cfg, N_SEQ, device, use_local_ba=False, mesh=mesh)
            results = [bt.track_batch(*frames(i), [np.linalg.inv(q[0][0]) for q in seqs] if i == 0 else None)
                       for i in range(n)]
            torch.cuda.synchronize()
            launches = read_counts()
            want = {"fast_score_dual": N_SEQ, "fast_score_dual_batched": n - 1, "fast_score": 0,
                    "fast_score_batched": 0, "hough_vote": N_SEQ, "hough_vote_batched": n - 1}
            log(f"distributed (a) {backend} world {dist.get_world_size()}: 1-rank mesh {mesh.shape}, launches "
                f"{launches}, collectives {dict(mesh.counts)}")
            if launches != want:
                raise AssertionError(f"distributed (a): launches {launches}, want {want}")
            _sharded_batch_gaps("distributed (a) 1-rank-mesh batch", [[x.state.name for x in r] for r in results],
                                np.array([[x.T_cw for x in r] for r in results]), ref, seqs)

            T_wc, grays, depths = synthetic.render_sequence(
                n=LOW_TEXTURE_FRAMES, scene=synthetic.make_room(0, low_texture=True, device=device), device=device)
            tr = Tracker(cfg, device)
            tr.mapper.use_distributed = True
            kf_log = keyframe_path_log(tr)
            states = [tr.track_rgbd(grays[i], depths[i], T_cw_init=np.linalg.inv(T_wc[0])).state.name
                      for i in range(LOW_TEXTURE_FRAMES)]
            est, base = tr.get_trajectory(), low_texture_tracker.get_trajectory()
            gap = float(np.abs(est[:, :3, 3] - base[:, :3, 3]).max())
            ts = np.arange(LOW_TEXTURE_FRAMES) / 30.0
            ate = float(evaluate.ate(ts, T_wc, ts, est, align="origin").rmse)
            ate0 = float(evaluate.ate(ts, T_wc, ts, base, align="origin").rmse)
            n_ba, n_single = len(kf_log["ba_ms"]), len(kf_log["ba"])
            # Two card runs of this room part at the keyframe decisions (the
            # scatter-adds' order), so the gates are the low_texture phase's
            # own, and every BA run must have been the single-device solve
            # (`_capture_ba` sees only `local_bundle_adjustment`).
            log(f"distributed (a) low_texture with use_distributed=True: LOST {sum(s != 'OK' for s in states)}, "
                f"local BA runs {n_ba}, of them single-device solves {n_single} (the low_texture run: "
                f"{len(low_texture_log['ba_ms'])}), ATE RMSE {ate:.6f} m (gate 0.05 m; the low_texture run "
                f"{ate0:.6f}), positions against the low_texture run max {gap * 1e3:.4f} mm")
            if set(states) != {"OK"} or not ate < 0.05 or n_ba < MIN_BA_RUNS or n_single != n_ba:
                raise AssertionError("distributed (a): the low-texture room with use_distributed=True departs")
        finally:
            dist.destroy_process_group()
    log(f"distributed (a): {time.perf_counter() - t0:.3f} s")

    # (b) Two ranks on this GPU over gloo.
    t0 = time.perf_counter()
    intr = cfg.camera
    dry = dist_worker.dryrun_inputs(intr, DIST_WORLD)
    captured = [({k: None if v is None else v.detach().cpu().numpy() for k, v in prob._asdict().items()},
                 res.kf_T_cw.detach().cpu().numpy(), float(res.chi2)) for prob, res in low_texture_log["ba"]]
    lm = dry["lm"]
    jobs = [
        ("ba", dict(probs=[dry["ba"]["prob"]] + [c[0] for c in captured], intr=tuple(intr),
                    single=[True] + [False] * len(captured))),
        ("pose_step", dict(**{k: lm[k] for k in ("T0", "X", "obs", "w")}, intr=tuple(intr), n_iters=10,
                           n_seqs=[lm["n_seq"], 1], single=True)),
        ("gba", dict(probs=[dry["gba"]["prob"]], intr=tuple(intr), n_iters=8, single=True)),
        ("pose_graph", dict(pg=dry["pg"]["pg"], n_iters=12, single=True)),
        ("db", dict(dbs=[dry["db"]])),
        ("batch", dict(cfg=cfg, seeds=tuple(range(N_SEQ)), n=n)),
    ]
    with tempfile.TemporaryDirectory() as d:
        ranks = dist_worker.run_ranks(jobs, DIST_WORLD, d, device=str(device), backend="gloo", timeout_s=600)
    secs = time.perf_counter() - t0

    def twist_err(T_est, T_gt):
        return float(se3.log_se3(torch.from_numpy(np.asarray(T_gt, np.float32))
                                 @ se3.inv(torch.from_numpy(np.asarray(T_est, np.float32)))).abs().max())

    bad = []
    for r, out in enumerate(ranks):
        ba = out["ba"]["runs"]
        err_ba = twist_err(ba[0]["kf_T"], dry["ba"]["T_gt"])
        steps = out["pose_step"]["runs"]
        err_lm = [twist_err(x["T"], lm["T_gt"]) for x in steps]
        lm_gap = max(float(np.abs(x["T"] - out["pose_step"]["single_T"]).max()) for x in steps)
        g = out["gba"]["runs"][0]
        gba_gap = float(np.abs(g["kf_T"] - g["single_kf_T"]).max())
        pg = out["pose_graph"]
        pg_gap = float(np.abs(pg["T"] - pg["single_T"]).max())
        dense = KeyFrameDatabase(dry["db"]["capacity"])
        for slot, h in dry["db"]["adds"]:
            dense.add(slot, h)
        q, k, x = dry["db"]["queries"][0]
        (ids_s, s_s), (ids_d, s_d) = out["db"]["runs"][0]["results"][0], dense.query(q, top_k=k, exclude=x)
        db_ok = list(ids_s) == list(ids_d) and np.allclose(s_s, s_d, atol=1e-5)
        log(f"distributed (b) rank {r}/{DIST_WORLD} (gloo, {device}): dist BA twist err {err_ba:.3e} "
            f"(gate 1e-5), {ba[0]['collectives']} in {ba[0]['seconds'] * 1e3:.3f} ms; pose LM meshes "
            f"{[x['mesh'] for x in steps]} twist err {[f'{e:.3e}' for e in err_lm]} (gate 1e-5), vs one rank "
            f"{lm_gap:.3e}, {[x['collectives'] for x in steps]}; dist global BA vs single {gba_gap:.3e} "
            f"(gate 1e-4), {g['collectives']} in {g['seconds'] * 1e3:.3f} ms; dist pose graph vs single "
            f"{pg_gap:.3e} (gate 1e-4), {pg['collectives']} in {pg['seconds'] * 1e3:.3f} ms; sharded BoW top-5 "
            f"{[int(i) for i in ids_s]} vs dense {[int(i) for i in ids_d]}, {out['db']['runs'][0]['collectives']}")
        if not (err_ba < 1e-5 and max(err_lm) < 1e-5 and lm_gap < 1e-5 and gba_gap < 1e-4 and pg_gap < 1e-4
                and db_ok and np.isfinite(g["chi2"])):
            bad.append(f"rank {r}: dry-run paths")
        b = out["batch"]
        lo, hi = b["local_seqs"]
        want = {"fast_score_dual": hi - lo, "fast_score_dual_batched": n - 1, "hough_vote": hi - lo,
                "hough_vote_batched": n - 1}
        log(f"distributed (b) rank {r}: sharded batch, sequences {lo}-{hi - 1} here, launches {b['launches']}, "
            f"collectives {b['collectives']}, {b['seconds']:.3f} s")
        if b["launches"] != want:
            bad.append(f"rank {r}: batch launches {b['launches']}, want {want}")
        _sharded_batch_gaps(f"distributed (b) rank {r} sharded batch", b["states"], b["poses"], ref, seqs)
        for i, ((_, T_card, chi2_card), run) in enumerate(zip(captured, ba[1:])):
            gaps = [pose_gap(a, c) for a, c in zip(run["kf_T"], T_card)]
            dt, dr = max(x[0] for x in gaps), max(x[1] for x in gaps)
            rel = abs(run["chi2"] - chi2_card) / max(chi2_card, 1e-12)
            log(f"distributed (b) rank {r} low_texture BA run {i}: over {DIST_WORLD} ranks vs the single-device "
                f"card solve, keyframe poses {dt * 1e3:.4f} mm {dr:.5f} deg, cost {run['chi2']:.4f} vs "
                f"{chi2_card:.4f}, {run['collectives']} in {run['seconds'] * 1e3:.3f} ms, dropped "
                f"{run['n_dropped']}")
            if not (dt < DIST_BA_GAP[0] and dr < DIST_BA_GAP[1] and rel <= DIST_BA_GAP[2]):
                bad.append(f"rank {r}: low_texture BA run {i}")
    for key in ("kf_T", "pt_X_perm", "e_inlier", "le_inlier"):
        for i, (a, c) in enumerate(zip(ranks[0]["ba"]["runs"], ranks[1]["ba"]["runs"])):
            if not np.array_equal(a[key], c[key]):
                bad.append(f"BA problem {i}: {key} differs between the ranks")
    for key, a, c in (("pose graph", ranks[0]["pose_graph"]["T"], ranks[1]["pose_graph"]["T"]),
                      ("global BA", ranks[0]["gba"]["runs"][0]["kf_T"], ranks[1]["gba"]["runs"][0]["kf_T"]),
                      ("batch", ranks[0]["batch"]["poses"], ranks[1]["batch"]["poses"])):
        if not np.array_equal(a, c):
            bad.append(f"{key}: the replicated outputs differ between the ranks")
    log(f"distributed (b): {DIST_WORLD} ranks, {len(captured)} captured BA problems, job seconds per rank "
        f"{[{k: round(v['job_seconds'], 3) for k, v in o.items()} for o in ranks]}, {secs:.3f} s in all")
    if bad:
        raise AssertionError(f"distributed (b): {bad}")
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
    rows.update(check_pose_lm(device, cycles_per_ms, seqs, built["pose_lm"]))

    # 3-9. The paths, each with its own launch counts.
    paths = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        log(f"phase {name}: {time.perf_counter() - t0:.3f} s")
        return out

    paths["points"], *_ = timed("points", run_path, "points", device, cfg_points, frames, ATE_GATE_POINTS_M, card)
    paths["lines"], lines_ms, *_ = timed("lines", run_path, "lines", device, cfg_lines, frames, ATE_GATE_LINES_M,
                                         card)
    paths["full"], full_ms, full_p90, _ = timed("full", run_path, "full", device, cfg_full, frames,
                                                1.5 * JAX_FULL_ATE_M, card, lines_ms)
    paths["default"], default_ms, default_p90, default_ate = timed(
        "default", run_path, "default", device, tum3_config(), frames, min(1.5 * JAX_DEFAULT_ATE_M, 0.02), card, lines_ms,
        use_local_ba=True, jax_triangulated=JAX_DEFAULT_TRIANGULATED, use_loop_closing=True)
    log(f"default path: ms/tracked frame median {default_ms:.3f} p90 {default_p90:.3f} beside the full "
        f"path's median {full_ms:.3f} p90 {full_p90:.3f} in this call")
    paths["low_texture"], low_texture_logs, low_texture_tracker = timed("low_texture", run_low_texture, device, card)
    paths["reloc"] = timed("reloc", run_reloc, device, card, frames)
    paths["loop"] = timed("loop", run_loop, device, card, low_texture_tracker.vomap, tum3_config().camera)
    paths["batch"], *_ = timed("batch", run_batch_path, "batch", device, cfg_lines, seqs, card, lines_ms,
                                        {"ate": JAX_BATCH_ATE_M, "lines": JAX_BATCH_LINE_INLIERS})
    paths["batch_full"], *_, batch_full_results = timed(
        "batch_full", run_batch_path, "batch_full", device, tum3_config(), seqs, card, lines_ms,
        {"ate": JAX_BATCH_FULL_ATE_M, "lines": JAX_BATCH_FULL_LINE_INLIERS, "planes": JAX_BATCH_FULL_PLANE_INLIERS})
    paths["batch_ba"], _, _, ba_fps, _, ba_ates, _ = timed(
        "batch_ba", run_batch_path, "batch_ba", device, tum3_config(), seqs, card, lines_ms,
        {"ate": JAX_BATCH_BA_ATE_M, "ba_runs": JAX_BATCH_BA_RUNS}, use_local_ba=True)
    paths["batch_lost"] = timed("batch_lost", run_batch_lost, device, card, seqs)
    timed("leftovers", run_leftovers, device, card)
    paths.update(timed("adversarial", run_adversarial, device, card))
    # The distributed layer: a 1-rank NCCL group here, then two ranks.
    paths["distributed"] = timed("distributed", run_distributed, device, card, seqs, batch_full_results,
                                 low_texture_logs["hybrid"], low_texture_tracker)
    # The facade and IO, and the pipelined paths.
    import tempfile

    with tempfile.TemporaryDirectory() as workdir:
        cli_out = timed("cli", run_cli, device, card, workdir)
        paths["cli"] = cli_out["launches"]
        paths["stream"] = timed("stream", run_stream, device, card, cli_out, workdir)["launches"]
    fps_frames = synthetic.render_sequence(n=ASYNC_FPS_FRAMES, seed=0, device=device)
    async_out = timed("async", run_async, device, card, frames, default_ate, fps_frames)
    paths.update({k: v for k, v in async_out.items() if isinstance(v, dict)})
    paths.update(timed("batch_async", run_batch_async, device, card, seqs, {"ate": ba_ates, "fps": ba_fps}))
    paths.update(timed("endurance", run_endurance, device, card))
    for name, row in rows.items():
        by_path = row.setdefault("launches_by_path", {})
        by_path.update({path: counts[name] for path, counts in paths.items() if name in counts})
        # `launches` counts the main path, the JAX package's default system.
        # K2 and K2b are on no tracking path: theirs are those of their own
        # entry point's run (check_fast).
        row["launches_path"] = "pyramid_fast_scores" if name in ("fast_score", "fast_score_batched") else "default"
        row["launches"] = by_path[row["launches_path"]]

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
