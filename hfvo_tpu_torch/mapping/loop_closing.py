"""Loop closing: detection, geometric verification, pose-graph correction.

Port of `hfvo_tpu.mapping.loop_closing` (reference: src/LoopClosing.cc,
whose work loop ships dormant there, :57-101): BoW candidates from the
keyframe database with the covisible region excluded by co-observation
(DetectLoop, src/LoopClosing.cc:123-130), a consecutive-detection
consistency gate (mnCovisibilityConsistencyTh, src/LoopClosing.cc:160-208),
geometric verification by mutual descriptor matching and 3D-3D Kabsch
RANSAC (the reference's RGB-D Sim3 with the scale fixed,
src/LoopClosing.cc:233), an SE(3) pose graph over odometry and loop edges
(OptimizeEssentialGraph, src/Optimizer.cc:4339), the correction of every
landmark type with its owning keyframe, the duplicate-landmark fuse
(CorrectLoop + SearchAndFuse, src/LoopClosing.cc:404-560) and a global BA
(src/LoopClosing.cc:580-581). The matching, RANSAC, pose graph and global
BA run on the tracker's device; the rest is the JAX package's numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..config import VOConfig
from ..ops.batch import resolve_device, to_host
from ..solve.global_ba import run_global_ba
from ..solve.pose_graph import PoseGraph, optimize_pose_graph
from ..solve.ransac import ransac_rigid_3d3d
from ..vomap.map import VOMap

# Consecutive detections of the candidate region before geometric
# verification (hfvo_tpu/mapping/loop_closing.py:46; the reference asks for 3
# covisibility groups, src/LoopClosing.cc:105-208; 2 here, with RANSAC and the
# pose graph's residual still gating the geometry). Every closure ends with
# the full-map BA (hfvo_tpu/mapping/loop_closing.py:50, src/LoopClosing.cc:580-581).
CONSISTENCY_TH = 2


@dataclass
class LoopCloser:
    cfg: VOConfig
    vomap: VOMap
    device: torch.device = "cuda"  # where matching, RANSAC and the solvers run (the tracker's)
    min_gap_kfs: int = 15  # a candidate must be this many keyframes older (by order)
    min_score: float = 0.12
    min_inliers: int = 40
    n_loops_closed: int = 0
    last_loop_order: int = -100
    _consistent_group: set = field(default_factory=set)
    _consistency_count: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _up(self, a: np.ndarray) -> torch.Tensor:
        with tracing.span("upload"):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _detect_candidate(self, tracker, cur: int) -> Optional[int]:
        """BoW candidate outside the covisible region, then the consistency
        gate (hfvo_tpu/mapping/loop_closing.py:59-96)."""
        vm = self.vomap
        kf = vm.keyframes
        order = vm.kf_slots_by_order()
        hist = tracker.kf_db.hists[cur]
        scores = 1.0 - 0.5 * np.abs(tracker.kf_db.hists - hist[None, :]).sum(axis=1)
        scores[~tracker.kf_db.valid] = -1.0
        scores[~kf.valid] = -1.0
        # Exclude by co-observation (covisible keyframes share the very
        # points a loop would re-find) and by insertion-order proximity.
        scores[vm.covisible_kfs(cur, min_weight=1, cap=0)] = -1.0
        near = np.abs(kf.order[order] - kf.order[cur]) < self.min_gap_kfs
        scores[order[near]] = -1.0
        cand = int(np.argmax(scores))
        if scores[cand] < self.min_score:
            self._consistency_count = 0
            self._consistent_group = set()
            return None
        # The candidate region (candidate + its covisible group) must recur
        # over consecutive keyframe insertions.
        group = set(vm.covisible_kfs(cand, min_weight=1, cap=0).tolist())
        group.add(cand)
        if group & self._consistent_group:
            self._consistency_count += 1
        else:
            self._consistency_count = 1
        self._consistent_group = group
        if self._consistency_count < CONSISTENCY_TH:
            return None
        return cand

    def detect_and_close(self, tracker) -> bool:
        """Try to close a loop at the newest keyframe (hfvo_tpu/mapping/
        loop_closing.py:98-225). Returns True if a loop was found and the
        map corrected."""
        from ..tracking import matcher

        vm = self.vomap
        cur = vm.newest_kf_slot
        kf = vm.keyframes
        if cur < 0 or vm.n_keyframes() < self.min_gap_kfs:
            return False
        if kf.order[cur] - self.last_loop_order < 10:
            return False
        cand = self._detect_candidate(tracker, cur)
        if cand is None:
            return False

        # Geometric verification: the current keyframe's observed points
        # against the candidate's, and RANSAC of the relative camera motion.
        idx_b, mok = to_host(list(matcher.match_descriptors_mutual(
            self._up(kf.desc[cur].astype(np.int64)), self._up(kf.obs_valid[cur]),
            self._up(kf.desc[cand].astype(np.int64)), self._up(kf.obs_valid[cand]),
        )))
        pid_cur = kf.point_id[cur]
        pid_cand = kf.point_id[cand][idx_b]
        good = (
            mok
            & (pid_cur >= 0) & (pid_cand >= 0)
            & vm.points.valid[np.maximum(pid_cur, 0)]
            & vm.points.valid[np.maximum(pid_cand, 0)]
        )
        if good.sum() < self.min_inliers:
            return False
        # Each side's landmark in its own keyframe's camera frame.
        T_cur, T_cand = kf.T_cw[cur], kf.T_cw[cand]
        Xb = (T_cur[:3, :3] @ vm.points.X_w[np.maximum(pid_cur, 0)].T).T + T_cur[:3, 3]
        Xa = (T_cand[:3, :3] @ vm.points.X_w[np.maximum(pid_cand, 0)].T).T + T_cand[:3, 3]
        res = ransac_rigid_3d3d(
            self._up(Xa.astype(np.float32)), self._up(Xb.astype(np.float32)), self._up(good),
            int(cur), inlier_th=0.08, min_inliers=self.min_inliers,
        )
        T_cand_cur, ok = to_host([res.T_ab, res.ok])  # candidate cam <- current cam
        if not bool(ok):
            return False

        with tracing.span("loop.close"):
            # Pose graph: odometry edges between order-consecutive keyframes
            # (from the current estimates) and the loop edge; the oldest fixed.
            kf_ids = vm.kf_slots_by_order()
            K = len(kf_ids)
            slot_of = {int(s): i for i, s in enumerate(kf_ids)}
            T = kf.T_cw[kf_ids].astype(np.float32)
            e_i, e_j, e_T, e_w = [], [], [], []
            for a, b in zip(kf_ids[:-1], kf_ids[1:]):
                i, j = slot_of[int(a)], slot_of[int(b)]
                e_i.append(i)
                e_j.append(j)
                e_T.append(T[i] @ np.linalg.inv(T[j]))
                e_w.append(1.0)
            e_i.append(slot_of[cand])
            e_j.append(slot_of[cur])
            e_T.append(T_cand_cur)  # T_cand @ inv(T_cur corrected)
            e_w.append(2.0)
            # The JAX package pads the graph to a power of two (fixed identity
            # poses, zero-weight edges) only to reuse its compiles; the port
            # solves it at its own size.
            free = np.arange(K) > 0
            pg = PoseGraph(*(self._up(a) for a in (
                T, free, np.asarray(e_i, np.int64), np.asarray(e_j, np.int64),
                np.stack(e_T).astype(np.float32), np.asarray(e_w, np.float32))))
            T_new = to_host([optimize_pose_graph(pg)])[0]
        if not np.isfinite(T_new).all():
            return False

        self._correct_landmarks(kf_ids, T, T_new)
        kf.T_cw[kf_ids] = T_new
        self.n_loops_closed += 1
        self.last_loop_order = int(kf.order[cur])
        self._consistency_count = 0
        self._consistent_group = set()
        # Post-loop fuse: the corrected sides of the loop now overlap, so
        # duplicated points and planes merge (SearchAndFuse,
        # src/LoopClosing.cc:560).
        if tracker is not None and hasattr(tracker, "mapper"):
            tracker.mapper.fuse_points()
            vm.merge_planes()
            tracker.invalidate_map_snapshot()
        # Gauge = the loop (candidate-side) keyframe: the freshly verified
        # region anchors the map (src/Optimizer.cc:280-296).
        with tracing.span("loop.gba"):
            run_global_ba(vm, self.cfg.camera, gauge_kf=int(cand), device=self.device)
        if tracker is not None and hasattr(tracker, "invalidate_map_snapshot"):
            tracker.invalidate_map_snapshot()
        return True

    def _correct_landmarks(self, kf_ids: np.ndarray, T_old: np.ndarray, T_new: np.ndarray) -> None:
        """Apply each keyframe's pose correction M = inv(T_new) @ T_old (old
        world -> corrected world) to every landmark it owns: points, line
        endpoints, and plane coefficients, centroids and accumulated moments
        (a rigid pushforward in float64, so later refits stay consistent;
        CorrectLoop, src/LoopClosing.cc:439-474)."""
        vm = self.vomap
        pt, ln, pl = vm.points, vm.lines, vm.planes
        slot_of = {int(s): i for i, s in enumerate(kf_ids)}
        for s in kf_ids:
            i = slot_of[int(s)]
            M = np.linalg.inv(T_new[i]) @ T_old[i]
            if np.allclose(M, np.eye(4), atol=1e-9):
                continue
            R, t = M[:3, :3], M[:3, 3]
            sel = pt.valid & (pt.first_kf == s)
            if sel.any():
                pt.X_w[sel] = (R @ pt.X_w[sel].T).T + t
            lsel = ln.valid & (ln.first_kf == s)
            if lsel.any():
                ln.X0_w[lsel] = (R @ ln.X0_w[lsel].T).T + t
                ln.X1_w[lsel] = (R @ ln.X1_w[lsel].T).T + t
            psel = pl.valid & (pl.first_kf == s)
            if psel.any():
                n_new = pl.pi_w[psel, :3] @ R.T
                pl.pi_w[psel, 3] = pl.pi_w[psel, 3] - n_new @ t
                pl.pi_w[psel, :3] = n_new
                pl.centroid_w[psel] = (R @ pl.centroid_w[psel].T).T + t
                Rd, td = R.astype(np.float64), t.astype(np.float64)
                m_sum = pl.m_sum[psel]
                m_w = pl.m_w[psel]
                Rs = m_sum @ Rd.T  # (n, 3) = R m_sum
                pl.m_outer[psel] = (
                    np.einsum("ab,nbc,dc->nad", Rd, pl.m_outer[psel], Rd)
                    + Rs[:, :, None] * td[None, None, :]
                    + td[None, :, None] * Rs[:, None, :]
                    + m_w[:, None, None] * np.outer(td, td)[None]
                )
                pl.m_sum[psel] = Rs + m_w[:, None] * td[None, :]
