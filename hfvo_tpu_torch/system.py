"""System facade: the public entry point mirroring the reference's `System`.

Port of `hfvo_tpu.system.VOSystem` (reference: src/System.cc — constructor
wiring `System::System` :36, `TrackRGBD` :178, `Shutdown` :325,
`SaveTrajectoryTUM` :346, `SaveKeyFrameTrajectoryTUM` :428,
`SavePointCloud` :552, `ActivateLocalizationMode` :297, `Reset` :319, timing
report `ExtractTimes` :406). The configuration is passed in, read from a
reference-format settings YAML, or tum3's; a trained DBoW2 vocabulary and
the live HTTP viewer are options. Local mapping and loop closing run
synchronously after keyframe insertion, so `VOSystem` is a thin stateful
wrapper around `Tracker` plus trajectory bookkeeping, timing accumulators
and savers; the savers write the JAX package's text formats byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from . import tracing
from .config import VOConfig, tum3_config
from .io import trajectory
from .tracking.tracker import Tracker, TrackResult


@dataclass
class StageTimes:
    """Per-frame wall times of the facade (reference: System::ExtractTimes,
    src/System.cc:406-425): the `facade.track` span's seconds and count."""

    stages: dict = field(default_factory=dict)

    @property
    def track_total(self) -> float:
        return self.stages.get("facade.track", [0.0, 0])[0]

    @property
    def n_frames(self) -> int:
        return self.stages.get("facade.track", [0.0, 0])[1]

    def report(self, tracker) -> str:
        """Mean time a frame, and a local BA run: the tracker's `local_ba`
        span over the runs its mapper counts."""
        ba_s = tracker.stage_times.get("local_ba", [0.0, 0])[0]
        n_ba = tracker.mapper.n_ba_runs
        lines = [
            f"mean tracking time: {self.track_total / max(self.n_frames, 1) * 1000:.2f} ms "
            f"over {self.n_frames} frames",
            f"mean local BA time: {ba_s / max(n_ba, 1) * 1000:.2f} ms over {n_ba} runs",
        ]
        return "\n".join(lines)


class VOSystem:
    """Hybrid-feature RGB-D VO system: with the defaults, the JAX package's
    default system (tum3, local BA, loop closing and the early-loss reset
    on).

    Runs on the card unless `device` asks for the CPU; without a card the
    default raises."""

    def __init__(
        self,
        config: Optional[VOConfig] = None,
        device: torch.device | str = "cuda",
        use_local_ba: bool = True,
        use_loop_closing: bool = True,
        settings_yaml: Optional[str] = None,
        vocabulary_path: Optional[str] = None,
        use_viewer: bool = False,
        viewer_port: int = 0,
    ):
        if vocabulary_path is not None:
            # Trained DBoW2 vocabulary for relocalization and loop retrieval
            # (reference: System ctor loads ORBvoc.txt, src/System.cc:70-74),
            # set before the tracker exists, as the JAX package does.
            # Without one, the file-free LSH bank is used.
            from .bow.vocab import set_vocabulary

            set_vocabulary(vocabulary_path)
        if config is None and settings_yaml is not None:
            from .io.yaml_config import config_from_yaml

            config = config_from_yaml(settings_yaml)
        self.cfg = config or tum3_config()
        self.tracker = Tracker(
            self.cfg, device, use_local_ba=use_local_ba, use_loop_closing=use_loop_closing
        )
        self.timestamps: List[float] = []
        self.times = StageTimes()
        self._localization_only = False
        self.viewer = None
        if use_viewer:
            # Live HTTP viewer thread (reference: System spawns the Pangolin
            # Viewer thread when useViewer is set, src/System.cc:108-113).
            from .viz.live import LiveViewer

            self.viewer = LiveViewer(self.tracker, port=viewer_port)
            print(f"live viewer: http://127.0.0.1:{self.viewer.port}/", flush=True)

    # ------------------------------------------------------------------

    def track_rgbd(
        self, gray: np.ndarray, depth_m: np.ndarray, timestamp: float
    ) -> TrackResult:
        """Process one frame (reference: System::TrackRGBD, src/System.cc:178).

        gray: (H, W) float32 intensity [0, 255] or uint8; depth_m: (H, W)
        float32 metres (already divided by DepthMapFactor) or uint16
        millimetres."""
        with tracing.facade(self.times.stages, seq=0, frame=self.tracker.frame_id + 1):
            if self._localization_only:
                # Track against the frozen map: no keyframe insertion, so no
                # BA (reference: ActivateLocalizationMode, src/System.cc:297).
                old_need = self.tracker._need_new_keyframe
                self.tracker._need_new_keyframe = lambda n, f=None, p=None: False  # type: ignore
                try:
                    res = self.tracker.track_rgbd(gray, depth_m)
                finally:
                    self.tracker._need_new_keyframe = old_need  # type: ignore
            else:
                res = self.tracker.track_rgbd(gray, depth_m)
            self.timestamps.append(timestamp)
        if self.viewer is not None:
            self.viewer.publish(gray, res)
        return res

    # ------------------------------------------------------------------

    def activate_localization_mode(self) -> None:
        self._localization_only = True

    def deactivate_localization_mode(self) -> None:
        self._localization_only = False

    def reset(self) -> None:
        """Full reset (reference: System::Reset -> Tracking::Reset,
        src/Tracking.cc:3923: clear map, database, counters)."""
        self.tracker.reset()
        self.tracker._traj_rel = []
        self.tracker.frame_id = -1
        self.timestamps = []
        self.times = StageTimes()

    def shutdown(self) -> None:
        """Stop the viewer thread if one was spawned (reference:
        System::Shutdown joins the Viewer thread, src/System.cc:325-340)."""
        if self.viewer is not None:
            self.viewer.close()
            self.viewer = None

    # ------------------------------------------------------------------

    def get_trajectory(self) -> np.ndarray:
        return self.tracker.get_trajectory()

    def save_trajectory_tum(self, path: str) -> None:
        """(reference: System::SaveTrajectoryTUM, src/System.cc:346 — poses
        chained through the reference keyframes.)"""
        T_wc = self.tracker.get_trajectory()
        trajectory.save_tum(path, self.timestamps[: len(T_wc)], T_wc)

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        """(reference: System::SaveKeyFrameTrajectoryTUM, src/System.cc:428.)"""
        vm = self.tracker.vomap
        ks = np.nonzero(vm.keyframes.valid)[0]
        T_wc = np.linalg.inv(vm.keyframes.T_cw[ks])
        ts = [self.timestamps[f] if f < len(self.timestamps) else float(f)
              for f in vm.keyframes.frame_id[ks]]
        trajectory.save_tum(path, ts, T_wc)

    def save_trajectory_kitti(self, path: str) -> None:
        """KITTI format: 12 numbers per line, row-major 3x4 of T_wc
        (reference: System::SaveTrajectoryKITTI, src/System.cc:497)."""
        T_wc = self.tracker.get_trajectory()
        with open(path, "w") as f:
            for T in T_wc:
                f.write(" ".join(f"{v:.9e}" for v in T[:3].reshape(-1)) + "\n")

    def save_point_cloud_ply(self, path: str) -> None:
        """Map points as ASCII PLY (reference: System::SavePointCloud,
        src/System.cc:552)."""
        vm = self.tracker.vomap
        X = vm.points.X_w[vm.points.valid]
        with open(path, "w") as f:
            f.write(
                "ply\nformat ascii 1.0\n"
                f"element vertex {len(X)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n"
            )
            for p in X:
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")

    def extract_times(self) -> str:
        """Timing report (reference: System::ExtractTimes, src/System.cc:406):
        mean per-frame and local BA times plus the tracker's stage timers
        (fused step, keyframe insertion, fusion, culling)."""
        stages = self.tracker.stage_report()
        return self.times.report(self.tracker) + ("\n" + stages if stages else "")
