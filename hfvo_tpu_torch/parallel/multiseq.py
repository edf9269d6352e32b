"""Multi-sequence batch tracking: S sequences in lockstep on one device.

Port of the synchronous path of `hfvo_tpu.parallel.multiseq.BatchTracker`
(hfvo_tpu/parallel/multiseq.py:121-189). S independent trackers advance one
frame per call through ONE fused step over a leading sequence axis (the
JAX package vmaps its step; here every function of the step takes the axis,
and a single Tracker runs the same step at S = 1). The step's launches,
FAST (K1b) and the Hough vote (K3b) among them, are shared by the batch,
and its result comes back with one host synchronization. A sequence that is
not initialized runs its own tracker's initialization on its own.

The host bookkeeping after the step is the JAX package's, sequence by
sequence: pose and velocity or LOST, the keyframe policy, keyframe
insertion, local BA when it is on, a fresh snapshot, the trajectory. Like
the reference's synchronous batch path it skips what `Tracker._post_track`
does after a single-sequence step: the wide-window retry, the coarse
Manhattan retry before a keyframe (a sequence tries it only at its
initialization), triangulation, point and line fusion, descriptor
re-election and keyframe culling (ROADMAP queue 3). Every configuration of
the tracking step runs, the full step (lines, planes, Manhattan axes)
included.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import VOConfig
from ..tracking.tracker import (
    Tracker,
    TrackResult,
    TrackState,
    _gray_u8,
    resolve_device,
    run_fused_step,
)


@dataclass
class BatchTracker:
    """Run S trackers whose per-frame device work is one batched step."""

    cfg: VOConfig
    n_seq: int
    device: torch.device = "cuda"
    use_local_ba: bool = True
    mesh: Optional[object] = None
    pipeline_depth: int = 1
    trackers: List[Tracker] = field(init=False)

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "BatchTracker(mesh=...) shards the sequence axis over devices; it "
                "arrives with the batch + distributed item, on torch.distributed"
            )
        if self.pipeline_depth > 1:
            raise NotImplementedError(
                "BatchTracker(pipeline_depth > 1) pipelines track_batch_async; it "
                "arrives with the facade + IO slice, beside Tracker.track_rgbd_async"
            )
        self.device = resolve_device(self.device)
        # The synchronous batch path never runs loop closing (the JAX
        # package's runs it only after a single-sequence step).
        self.trackers = [
            Tracker(self.cfg, self.device, use_local_ba=self.use_local_ba,
                    use_loop_closing=False)
            for _ in range(self.n_seq)
        ]

    def warmup(self) -> None:
        """Build the CUDA kernels ahead of the first batch. (The JAX
        package's warmup compiles its single-frame fallback programs; eager
        torch compiles nothing else.)"""
        if self.device.type == "cuda":
            from ..ops import _kernels

            _kernels.build_all(_kernels.names())

    def track_batch(
        self,
        grays: Sequence[np.ndarray],
        depths: Sequence[np.ndarray],
        T_cw_inits: Optional[Sequence[Optional[np.ndarray]]] = None,
    ) -> List[TrackResult]:
        """Advance every sequence by one frame. `grays[s]` is (H, W)
        intensity in [0, 255]; `depths[s]` float metres or uint16 mm;
        `T_cw_inits[s]` the pose of an initialization frame."""
        if len(grays) != self.n_seq or len(depths) != self.n_seq:
            raise ValueError(f"track_batch: expected {self.n_seq} frames, got {len(grays)}")
        for tr in self.trackers:
            tr.check_not_lost()
        results: List[Optional[TrackResult]] = [None] * self.n_seq
        batch_ids = []
        for s, tr in enumerate(self.trackers):
            if tr.state is TrackState.NOT_INITIALIZED:
                init = T_cw_inits[s] if T_cw_inits is not None else None
                results[s] = tr.track_rgbd(grays[s], depths[s], T_cw_init=init)
            else:
                tr.frame_id += 1
                batch_ids.append(s)
        if not batch_ids:
            return results  # type: ignore[return-value]

        head = self.trackers[batch_ids[0]]
        gray = head._upload(np.stack([_gray_u8(np.asarray(grays[s])) for s in batch_ids]))
        depth = head._upload(np.stack([
            self.trackers[s]._depth_host_u16(np.asarray(depths[s])) for s in batch_ids
        ]).astype(np.int32))
        args = [
            self.trackers[s].prepare_step(self.trackers[s].velocity @ self.trackers[s].T_cw)
            for s in batch_ids
        ]
        outs = run_fused_step(self.cfg, gray, depth, args, radius=15.0, check_octave=True)

        for s, a, (out, feed) in zip(batch_ids, args, outs):
            tr = self.trackers[s]
            ok, T_new, pt_per_kp, n_in, feats = tr.finish_step(out, a.pad, a.lpad, feed)
            is_kf = False
            if ok:
                tr.velocity = (T_new @ np.linalg.inv(tr.T_cw)).astype(np.float32)
                tr.T_cw = T_new
                tr.state = TrackState.OK
                if tr._need_new_keyframe(n_in, feats, pt_per_kp):
                    # No coarse Manhattan retry here: the batch path tries it
                    # only at a sequence's initialization.
                    tr._create_keyframe(feats, pt_per_kp)
                    is_kf = True
                    tr._local_ba()
                    tr.invalidate_map_snapshot()
            else:
                tr.state = TrackState.LOST
            tr._record_trajectory()
            results[s] = TrackResult(tr.state, tr.T_cw.copy(), n_in, is_kf)
        return results  # type: ignore[return-value]

    def get_trajectories(self) -> List[np.ndarray]:
        return [tr.get_trajectory() for tr in self.trackers]

    def track_batch_async(self, grays, depths):
        """The JAX package's pipelined batch path hides a remote transport's
        round trip; it is not part of this slice."""
        raise NotImplementedError(
            "BatchTracker.track_batch_async arrives with the facade + IO slice, "
            "beside Tracker.track_rgbd_async; use track_batch"
        )

    def flush(self):
        raise NotImplementedError(
            "BatchTracker.flush (of track_batch_async) arrives with the facade + IO "
            "slice; track_batch leaves nothing in flight"
        )
