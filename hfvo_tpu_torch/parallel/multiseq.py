"""Multi-sequence batch tracking: S sequences in lockstep on one device.

Port of `hfvo_tpu.parallel.multiseq.BatchTracker` on one device
(hfvo_tpu/parallel/multiseq.py:121-415). S independent trackers advance one
frame per call through ONE fused step over a leading sequence axis (the
JAX package vmaps its step; here every function of the step takes the axis,
and a single Tracker runs the same step at S = 1). The step's launches,
FAST (K1b) and the Hough vote (K3b) among them, are shared by the batch,
and its result comes back with one host synchronization. A sequence that is
not initialized runs its own tracker's initialization on its own.

`track_batch`: the host bookkeeping after the step is the JAX package's
synchronous one, sequence by sequence: pose and velocity or LOST (a LOST
sequence is stepped from its motion model inside the batch, with no
relocalization), the keyframe policy, keyframe insertion, local BA when it
is on, a fresh snapshot, the trajectory. Like the reference's synchronous
batch path it skips what `Tracker._post_track` does after a single-sequence
step: the wide-window retry, the coarse Manhattan retry before a keyframe
(a sequence tries it only at its initialization), triangulation, point and
line fusion, descriptor re-election, loop closing and keyframe culling
(ROADMAP queue 3).

`track_batch_async` is the pipelined path (:211-415): batch i is
dispatched against predictions chained on the in-flight batch poses, and
batch i - pipeline_depth is resolved after it, each sequence through the
full `Tracker._post_track` (as the JAX package does there, loop closing
included). A sequence whose result was not OK or needed a fallback poisons
its row in the batches still in flight, which re-track that sequence
synchronously when they resolve; a call that finds any sequence not OK
flushes and runs `track_batch`. Every configuration of the tracking step
runs, the full step (lines, planes, Manhattan axes) included.
"""
from __future__ import annotations

import time
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
    collect_fused_step,
    launch_fused_step,
    run_fused_step,
)

# Most recent step_times entries kept per phase (see track_batch_async).
_STEP_TIMES_CAP = 512


@dataclass
class BatchTracker:
    """Run S trackers whose per-frame device work is one batched step."""

    cfg: VOConfig
    n_seq: int
    device: torch.device = "cuda"
    use_local_ba: bool = True
    mesh: Optional[object] = None
    # In-flight batch budget of track_batch_async: batch i - depth is
    # resolved after batch i is dispatched.
    pipeline_depth: int = 1
    trackers: List[Tracker] = field(init=False)

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "BatchTracker(mesh=...) shards the sequence axis over devices; it "
                "arrives with the batch + distributed item (ROADMAP item 12), on torch.distributed"
            )
        self.device = resolve_device(self.device)
        # Loop closing is on, as in the JAX package's trackers: the
        # synchronous path never calls it, the pipelined path's
        # `_post_track` does.
        self.trackers = [
            Tracker(self.cfg, self.device, use_local_ba=self.use_local_ba)
            for _ in range(self.n_seq)
        ]
        self._pend_q: List[dict] = []  # in-flight batches, oldest first

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

    # ---- pipelined batch tracking ----------------------------------------

    def track_batch_async(
        self,
        grays: Sequence[np.ndarray],
        depths: Sequence[np.ndarray],
    ) -> List[TrackResult]:
        """Pipelined batch tracking (the S-sequence analogue of
        `Tracker.track_rgbd_async`): dispatch this frame's batched step
        against predictions chained on the in-flight batch poses, then
        resolve the batches more than `pipeline_depth` calls old. Returns the
        TrackResults that became final during this call, S per resolved
        batch (none on the first `pipeline_depth` calls); call `flush()` at
        the end."""
        if any(tr.state is not TrackState.OK for tr in self.trackers):
            out = list(self.flush())
            out.extend(r for r in self.track_batch(grays, depths) if r is not None)
            return out
        tm = getattr(self, "step_times", None)
        if tm is None:
            tm = self.step_times = {"prep": [], "upload": [], "dispatch": [], "resolve": []}
        for v in tm.values():
            if len(v) >= _STEP_TIMES_CAP:
                del v[: len(v) - _STEP_TIMES_CAP + 1]
        t0 = time.perf_counter()
        gray_h = [_gray_u8(np.asarray(g)) for g in grays]
        depth_h = [tr._depth_host_u16(np.asarray(d)) for tr, d in zip(self.trackers, depths)]
        pend = self._pend_q[-1] if self._pend_q else None
        fids, args = [], []
        for s, tr in enumerate(self.trackers):
            tr.frame_id += 1
            fids.append(tr.frame_id)
            if pend is None:
                T_pred = (tr.velocity @ tr.T_cw).astype(np.float32)
            else:
                # Constant velocity chained on the in-flight batched pose;
                # the baseline is the second-newest in-flight batch pose
                # (inverted as a matrix, see Tracker.track_rgbd_async), or
                # the last resolved one.
                T_a = pend["step"].T_cw[s]
                if len(self._pend_q) >= 2:
                    T_b = torch.linalg.inv(self._pend_q[-2]["step"].T_cw[s])
                else:
                    T_b = tr._upload(np.linalg.inv(tr.T_cw).astype(np.float32))
                T_pred = T_a @ T_b @ T_a
            a = tr.prepare_step(T_pred)
            if pend is not None and a.feed is not None:
                # As the JAX package's pipelined batch: the line channel's
                # previous pose and image are the in-flight batch's, its
                # segments the last resolved frame's.
                a = a._replace(T_prev=pend["step"].T_cw[s], feed=a.feed._replace(gray=pend["gray"][s]))
            args.append(a)
        tm["prep"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        head = self.trackers[0]
        gray = head._upload(np.stack(gray_h))
        depth = head._upload(np.stack(depth_h).astype(np.int32))
        tm["upload"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        step = launch_fused_step(self.cfg, gray, depth, args, radius=15.0, check_octave=True)
        self._pend_q.append(dict(step=step, gray=gray, depth=depth, fids=fids, poisoned=set()))
        tm["dispatch"].append(time.perf_counter() - t0)
        res: List[TrackResult] = []
        t0 = time.perf_counter()
        while len(self._pend_q) > self.pipeline_depth:
            res.extend(self._resolve_batch(self._pend_q.pop(0)))
        if res:
            tm["resolve"].append(time.perf_counter() - t0)
        return res

    def flush(self) -> List[TrackResult]:
        """Resolve every in-flight batch of track_batch_async."""
        res: List[TrackResult] = []
        while self._pend_q:
            res.extend(self._resolve_batch(self._pend_q.pop(0)))
        return res

    def _resolve_batch(self, p) -> List[TrackResult]:
        t0 = time.perf_counter()
        outs = collect_fused_step(p["step"])
        tm = getattr(self, "step_times", None)
        if tm is not None:
            tm.setdefault("pull", []).append(time.perf_counter() - t0)
        results: List[TrackResult] = []
        poisoned_next = []
        for s, tr in enumerate(self.trackers):
            saved_fid = tr.frame_id
            tr.frame_id = p["fids"][s]
            try:
                g, d = p["gray"][s:s + 1], p["depth"][s:s + 1]
                if s in p["poisoned"]:
                    # This row chained on a pose that turned out wrong:
                    # re-track it synchronously from the corrected state.
                    res = tr._track_prepared(g, d)
                else:
                    out, feed = outs[s]
                    a = p["step"].args[s]
                    five = tr.finish_step(out, a.pad, a.lpad, feed)
                    res = tr._post_track(five, g, d)
            finally:
                tr.frame_id = saved_fid
            if res.state is not TrackState.OK or tr._used_fallback:
                poisoned_next.append(s)
            results.append(res)
        for q in self._pend_q:
            q["poisoned"].update(poisoned_next)
        return results
