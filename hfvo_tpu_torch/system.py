"""System facade: the public entry point mirroring the reference's `System`.

Port of `hfvo_tpu.system.VOSystem` for the ported slices: tracking (points,
lines, planes, Manhattan axes) and the keyframe path (triangulation, local
BA), loop closing off (reference:
src/System.cc — `TrackRGBD` :178, `SaveTrajectoryTUM` :346, `Reset` :319,
`ExtractTimes` :406). The configuration is passed in; YAML settings, a
trained vocabulary and the live viewer belong to the facade + IO slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .config import VOConfig
from .io import trajectory
from .tracking.tracker import Tracker, TrackResult


@dataclass
class StageTimes:
    """Per-stage accumulated wall times (reference: System::ExtractTimes)."""

    track_total: float = 0.0
    n_frames: int = 0

    def report(self) -> str:
        n = max(self.n_frames, 1)
        return (
            f"mean tracking time: {self.track_total / n * 1000:.2f} ms over "
            f"{self.n_frames} frames"
        )


class VOSystem:
    """Hybrid-feature RGB-D VO system (tracking and the keyframe path; loop
    closing not yet).

    Runs on the card unless `device` asks for the CPU; without a card the
    default raises."""

    def __init__(
        self,
        config: VOConfig,
        device: torch.device | str = "cuda",
        use_local_ba: bool = True,
        use_loop_closing: bool = True,
        settings_yaml: Optional[str] = None,
        vocabulary_path: Optional[str] = None,
        use_viewer: bool = False,
    ):
        for given, name in (
            (settings_yaml, "settings_yaml"),
            (vocabulary_path, "vocabulary_path"),
            (use_viewer or None, "use_viewer"),
        ):
            if given is not None:
                raise NotImplementedError(
                    f"VOSystem: {name} arrives with the facade + IO slice"
                )
        self.cfg = config
        self.tracker = Tracker(
            config, device, use_local_ba=use_local_ba, use_loop_closing=use_loop_closing
        )
        self.timestamps: List[float] = []
        self.times = StageTimes()

    def track_rgbd(
        self, gray: np.ndarray, depth_m: np.ndarray, timestamp: float
    ) -> TrackResult:
        """Process one frame (reference: System::TrackRGBD, src/System.cc:178).

        gray: (H, W) float32 intensity [0, 255]; depth_m: (H, W) float32
        metres (already divided by DepthMapFactor) or uint16 millimetres."""
        t0 = time.perf_counter()
        res = self.tracker.track_rgbd(gray, depth_m)
        self.timestamps.append(timestamp)
        self.times.track_total += time.perf_counter() - t0
        self.times.n_frames += 1
        return res

    def reset(self) -> None:
        """Full reset (reference: System::Reset -> Tracking::Reset)."""
        self.tracker.reset()
        self.tracker._traj_rel = []
        self.tracker.frame_id = -1
        self.timestamps = []
        self.times = StageTimes()

    def get_trajectory(self) -> np.ndarray:
        return self.tracker.get_trajectory()

    def save_trajectory_tum(self, path: str) -> None:
        """(reference: System::SaveTrajectoryTUM, src/System.cc:346 — poses
        chained through the reference keyframes.)"""
        T_wc = self.tracker.get_trajectory()
        trajectory.save_tum(path, self.timestamps[: len(T_wc)], T_wc)

    def extract_times(self) -> str:
        """Timing report: mean per-frame time plus the tracker's stage
        timers (fused step, keyframe insertion, fusion, culling)."""
        stages = self.tracker.stage_report()
        return self.times.report() + ("\n" + stages if stages else "")
