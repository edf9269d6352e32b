"""Struct-of-arrays map: fixed-capacity landmark + keyframe tables.

Replaces the reference's pointer-graph map (`Map` of `std::set<KeyFrame*>`,
`MapPoint*` observation hashmaps guarded by mutexes — reference: src/Map.cc,
src/MapPoint.cc, src/KeyFrame.cc) with flat numpy tables on the host and
device snapshots for the jitted kernels. All bookkeeping (creation, culling,
observation counting) is vectorized numpy between frames; the hot per-frame
compute reads a read-only device snapshot (SURVEY.md §7 design stance).

Conventions: slot-indexed tables with `valid` masks; ids are slot indices.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import VOConfig


@dataclass
class PointTable:
    """Map points (reference: src/MapPoint.cc)."""

    X_w: np.ndarray  # (N, 3) float32
    desc: np.ndarray  # (N, 8) uint32 distinctive descriptor
    normal: np.ndarray  # (N, 3) mean viewing direction
    octave: np.ndarray  # (N,) int32 reference octave
    angle: np.ndarray  # (N,) float32 IC angle of the creating keypoint —
    # the reference side of the 30-bin rotation-consistency histogram
    # (reference: ORBmatcher HISTO_LENGTH rotation check, src/ORBmatcher.cc:37)
    valid: np.ndarray  # (N,) bool
    n_obs: np.ndarray  # (N,) int32 keyframe observations
    n_visible: np.ndarray  # (N,) int32 times predicted visible in tracking
    n_found: np.ndarray  # (N,) int32 times actually matched in tracking
    first_kf: np.ndarray  # (N,) int32
    last_seen_frame: np.ndarray  # (N,) int32

    @staticmethod
    def empty(n: int) -> "PointTable":
        return PointTable(
            X_w=np.zeros((n, 3), np.float32),
            desc=np.zeros((n, 8), np.uint32),
            normal=np.zeros((n, 3), np.float32),
            octave=np.zeros((n,), np.int32),
            angle=np.zeros((n,), np.float32),
            valid=np.zeros((n,), bool),
            n_obs=np.zeros((n,), np.int32),
            n_visible=np.zeros((n,), np.int32),
            n_found=np.zeros((n,), np.int32),
            first_kf=np.full((n,), -1, np.int32),
            last_seen_frame=np.full((n,), -1, np.int32),
        )


@dataclass
class LineTable:
    """Map lines — 3D endpoint landmarks (reference: src/MapLine.cpp:
    Vector6d endpoints, distinctive descriptor, Manhattan axis id)."""

    X0_w: np.ndarray  # (N, 3)
    X1_w: np.ndarray  # (N, 3)
    desc: np.ndarray  # (N, D) float32 band descriptor
    valid: np.ndarray  # (N,) bool
    n_obs: np.ndarray  # (N,) int32
    n_visible: np.ndarray  # (N,) int32
    n_found: np.ndarray  # (N,) int32
    manh_idx: np.ndarray  # (N,) int32 Manhattan axis id (-1 = none)
    last_seen_frame: np.ndarray  # (N,) int32
    first_kf: np.ndarray  # (N,) int32 owning keyframe (loop correction
    # transforms the line with its reference KF, as the reference's
    # CorrectLoop does for every landmark type, src/LoopClosing.cc:439-474)

    @staticmethod
    def empty(n: int, d: int) -> "LineTable":
        return LineTable(
            X0_w=np.zeros((n, 3), np.float32),
            X1_w=np.zeros((n, 3), np.float32),
            desc=np.zeros((n, d), np.float32),
            valid=np.zeros((n,), bool),
            n_obs=np.zeros((n,), np.int32),
            n_visible=np.zeros((n,), np.int32),
            n_found=np.zeros((n,), np.int32),
            manh_idx=np.full((n,), -1, np.int32),
            last_seen_frame=np.full((n,), -1, np.int32),
            first_kf=np.full((n,), -1, np.int32),
        )


@dataclass
class KeyFrameTable:
    """Keyframes with their full observation snapshot (reference:
    src/KeyFrame.cc keeps keypoints, descriptors, and landmark pointers).

    `point_id[k, i]` is the map-point slot observed by keypoint i of KF k
    (-1 = none). `obs[k, i]` is the (u, v, u_r) measurement; `octave` scales
    the information matrix in BA.
    """

    T_cw: np.ndarray  # (K, 4, 4)
    valid: np.ndarray  # (K,) bool
    frame_id: np.ndarray  # (K,) int32 source frame
    order: np.ndarray  # (K,) int64 insertion sequence (-1 empty). Slots are
    # recycled after culling (reference map is unbounded; here a free-list
    # keeps the fixed tables from exhausting), so slot index is NOT temporal
    # order — this field is.
    point_id: np.ndarray  # (K, C) int32
    obs: np.ndarray  # (K, C, 3) float32
    octave: np.ndarray  # (K, C) int32
    desc: np.ndarray  # (K, C, 8) uint32
    obs_valid: np.ndarray  # (K, C) bool
    kp_valid: np.ndarray  # (K, C) bool — real detected keypoint (regardless
    # of landmark association); epipolar triangulation candidates are
    # kp_valid & (point_id < 0) (reference keeps all keypoints in the
    # KeyFrame for CreateNewMapPoints, src/LocalMapping.cc:455)
    # Manhattan axis directions measured in this KF's camera frame (rows)
    # and their normal-support counts; 0 support disables the axis. Local
    # BA uses these as absolute per-KF rotation anchors.
    axes_c: np.ndarray  # (K, 3, 3) float32
    axes_sup: np.ndarray  # (K, 3) int32

    @staticmethod
    def empty(k: int, c: int) -> "KeyFrameTable":
        return KeyFrameTable(
            T_cw=np.tile(np.eye(4, dtype=np.float32), (k, 1, 1)),
            valid=np.zeros((k,), bool),
            frame_id=np.full((k,), -1, np.int32),
            order=np.full((k,), -1, np.int64),
            point_id=np.full((k, c), -1, np.int32),
            obs=np.zeros((k, c, 3), np.float32),
            octave=np.zeros((k, c), np.int32),
            desc=np.zeros((k, c, 8), np.uint32),
            obs_valid=np.zeros((k, c), bool),
            kp_valid=np.zeros((k, c), bool),
            axes_c=np.zeros((k, 3, 3), np.float32),
            axes_sup=np.zeros((k, 3), np.int32),
        )


@dataclass
class PlaneTable:
    """Map planes — Hessian-form landmarks (reference: src/MapPlane.cc:
    4-vector coefficients + a merged point cloud; here the cloud is the
    running centroid + support count, sufficient for association and the
    distance residual)."""

    pi_w: np.ndarray  # (N, 4) unit normal + d (n.X + d = 0)
    centroid_w: np.ndarray  # (N, 3)
    count: np.ndarray  # (N,) supporting pixels
    valid: np.ndarray  # (N,)
    n_obs: np.ndarray  # (N,)
    last_seen_frame: np.ndarray  # (N,)
    first_kf: np.ndarray  # (N,) owning keyframe for loop correction
    # Running world-frame point moments over ALL observations — the TPU
    # equivalent of the reference's merged voxel cloud (MapPlane::
    # UpdateCoefficientsAndPoints, src/MapPlane.cc:300-372): coefficients
    # refit from the accumulated scatter instead of a stored point cloud.
    # float64: moments are about the origin, so f32 would cancel.
    m_w: np.ndarray  # (N,) total weight (pixel count)
    m_sum: np.ndarray  # (N, 3) weighted position sum
    m_outer: np.ndarray  # (N, 3, 3) weighted second moment about origin

    @staticmethod
    def empty(n: int) -> "PlaneTable":
        return PlaneTable(
            pi_w=np.zeros((n, 4), np.float32),
            centroid_w=np.zeros((n, 3), np.float32),
            count=np.zeros((n,), np.float32),
            valid=np.zeros((n,), bool),
            n_obs=np.zeros((n,), np.int32),
            last_seen_frame=np.full((n,), -1, np.int32),
            first_kf=np.full((n,), -1, np.int32),
            m_w=np.zeros((n,), np.float64),
            m_sum=np.zeros((n, 3), np.float64),
            m_outer=np.zeros((n, 3, 3), np.float64),
        )


@dataclass
class KeyFramePlaneTable:
    """Per-keyframe plane observations."""

    plane_id: np.ndarray  # (K, C) int32
    pi_obs: np.ndarray  # (K, C, 4) camera-frame observation
    obs_valid: np.ndarray  # (K, C)

    @staticmethod
    def empty(k: int, c: int) -> "KeyFramePlaneTable":
        return KeyFramePlaneTable(
            plane_id=np.full((k, c), -1, np.int32),
            pi_obs=np.zeros((k, c, 4), np.float32),
            obs_valid=np.zeros((k, c), bool),
        )


@dataclass
class KeyFrameLineTable:
    """Per-keyframe line observations: which map line each detected segment
    observes, plus the observed 2D infinite line for BA edges. Raw segment
    geometry + descriptors are kept for EVERY detected segment (matched or
    not) so local mapping can triangulate new map lines across keyframes
    (reference: KeyFrame keeps mvKeyLines + mLineDescriptors for
    CreateNewMapLinesConstraint, src/LocalMapping.cc:1064)."""

    line_id: np.ndarray  # (K, C) int32, -1 = none
    line2d: np.ndarray  # (K, C, 3) normalized (a, b, c)
    obs_valid: np.ndarray  # (K, C)
    p0: np.ndarray  # (K, C, 2) float32 segment endpoints (pixels)
    p1: np.ndarray  # (K, C, 2)
    desc: np.ndarray  # (K, C, D) float32 band descriptors
    seg_valid: np.ndarray  # (K, C) detected segment (matched or not)

    @staticmethod
    def empty(k: int, c: int, d: int = 36) -> "KeyFrameLineTable":
        return KeyFrameLineTable(
            line_id=np.full((k, c), -1, np.int32),
            line2d=np.zeros((k, c, 3), np.float32),
            obs_valid=np.zeros((k, c), bool),
            p0=np.zeros((k, c, 2), np.float32),
            p1=np.zeros((k, c, 2), np.float32),
            desc=np.zeros((k, c, d), np.float32),
            seg_valid=np.zeros((k, c), bool),
        )


@dataclass
class VOMap:
    """Host-side map orchestrator."""

    cfg: VOConfig
    points: PointTable = field(init=False)
    lines: "LineTable" = field(init=False)
    planes: "PlaneTable" = field(init=False)
    keyframes: KeyFrameTable = field(init=False)
    kf_lines: "KeyFrameLineTable" = field(init=False)
    kf_planes: "KeyFramePlaneTable" = field(init=False)
    next_point_slot: int = 0
    next_kf_slot: int = 0

    def __post_init__(self):
        cap = self.cfg.cap
        self.points = PointTable.empty(cap.map_points)
        self.lines = LineTable.empty(cap.map_lines, 4 * 9)  # DESC_BANDS * 4
        self.planes = PlaneTable.empty(cap.map_planes)
        self.keyframes = KeyFrameTable.empty(cap.keyframes, cap.keypoints)
        self.kf_lines = KeyFrameLineTable.empty(cap.keyframes, cap.lines)
        self.kf_planes = KeyFramePlaneTable.empty(cap.keyframes, cap.planes)
        self.next_line_slot = 0
        self.next_plane_slot = 0
        # Keyframe slot free-list + insertion counter: culled slots are
        # recycled so long sequences never exhaust the fixed table (the
        # reference map is unbounded, src/Map.cc). `order` disambiguates
        # temporal order once slots recycle.
        self.free_kf_slots: list = []
        self.kf_order_counter: int = 0
        self.newest_kf_slot: int = -1

    # ---- keyframes -------------------------------------------------------

    def add_keyframe(
        self,
        T_cw: np.ndarray,
        frame_id: int,
        point_id: np.ndarray,
        obs: np.ndarray,
        octave: np.ndarray,
        desc: np.ndarray,
        obs_valid: np.ndarray,
        axes_c: np.ndarray | None = None,
        axes_sup: np.ndarray | None = None,
        kp_valid: np.ndarray | None = None,
    ) -> int:
        if self.free_kf_slots:
            k = self.free_kf_slots.pop(0)
        else:
            k = self.next_kf_slot
            if k >= self.keyframes.T_cw.shape[0]:
                raise RuntimeError(
                    "keyframe capacity exhausted and no culled slots to "
                    "recycle — raise cfg.cap.keyframes"
                )
            self.next_kf_slot += 1
        kf = self.keyframes
        kf.T_cw[k] = T_cw
        kf.valid[k] = True
        kf.frame_id[k] = frame_id
        kf.order[k] = self.kf_order_counter
        self.kf_order_counter += 1
        self.newest_kf_slot = k
        kf.point_id[k] = point_id
        kf.obs[k] = obs
        kf.octave[k] = octave
        kf.desc[k] = desc
        kf.obs_valid[k] = obs_valid
        kf.kp_valid[k] = obs_valid if kp_valid is None else kp_valid
        if axes_c is not None:
            kf.axes_c[k] = axes_c
            kf.axes_sup[k] = axes_sup
        else:
            kf.axes_c[k] = 0.0
            kf.axes_sup[k] = 0
        # Recycled slots must not inherit stale per-KF observations.
        self.kf_lines.line_id[k] = -1
        self.kf_lines.obs_valid[k] = False
        self.kf_lines.seg_valid[k] = False
        self.kf_planes.plane_id[k] = -1
        self.kf_planes.obs_valid[k] = False
        # Update observation counts.
        pids = point_id[obs_valid & (point_id >= 0)]
        np.add.at(self.points.n_obs, pids, 1)
        first = self.points.first_kf[pids] < 0
        self.points.first_kf[pids[first]] = k
        # Running mean viewing direction (reference:
        # MapPoint::UpdateNormalAndDepth re-averages over all observing
        # keyframes on every new observation, src/MapPoint.cc; consumed by
        # the Frame::isInFrustum viewCos gate).
        p = self.points
        C = np.linalg.inv(T_cw)[:3, 3]
        d = p.X_w[pids] - C
        d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
        w = np.maximum(p.n_obs[pids] - 1, 0).astype(np.float32)[:, None]
        mixed = p.normal[pids] * w + d
        p.normal[pids] = (
            mixed / (np.linalg.norm(mixed, axis=1, keepdims=True) + 1e-9)
        ).astype(np.float32)
        return k

    def release_keyframe(self, k: int) -> None:
        """Invalidate a culled keyframe and recycle its slot. Landmarks owned
        by it (first_kf) are re-owned to the nearest earlier surviving KF so
        loop correction keeps a valid reference (the reference re-parents
        along the spanning tree, src/KeyFrame.cc SetBadFlag)."""
        kf = self.keyframes
        pid = kf.point_id[k]
        ov = kf.obs_valid[k] & (pid >= 0)
        np.add.at(self.points.n_obs, pid[ov], -1)
        lid = self.kf_lines.line_id[k]
        lov = self.kf_lines.obs_valid[k] & (lid >= 0)
        np.add.at(self.lines.n_obs, lid[lov], -1)
        plid = self.kf_planes.plane_id[k]
        pov = self.kf_planes.obs_valid[k] & (plid >= 0)
        np.add.at(self.planes.n_obs, plid[pov], -1)
        kf.valid[k] = False
        kf.obs_valid[k] = False
        kf.kp_valid[k] = False
        kf.point_id[k] = -1
        self.kf_lines.obs_valid[k] = False
        self.kf_lines.line_id[k] = -1
        self.kf_lines.seg_valid[k] = False
        self.kf_planes.obs_valid[k] = False
        self.kf_planes.plane_id[k] = -1
        # Re-own landmarks to the closest surviving KF by insertion order.
        slots = self.kf_slots_by_order()
        if len(slots):
            dist = np.abs(kf.order[slots] - kf.order[k])
            parent = int(slots[np.argmin(dist)])
            for tab in (self.points, self.lines, self.planes):
                tab.first_kf[tab.first_kf == k] = parent
        kf.order[k] = -1
        self.free_kf_slots.append(int(k))

    def kf_capacity_left(self) -> int:
        return (
            self.keyframes.T_cw.shape[0] - self.next_kf_slot
            + len(self.free_kf_slots)
        )

    def weakest_kf(self, exclude_recent: int = 5) -> int:
        """The valid keyframe least covisible with the newest one (ties:
        oldest), excluding the `exclude_recent` newest. Used as the eviction
        victim under capacity pressure — a bounded-memory policy the
        unbounded reference never needs, chosen to drop the KF whose loss
        least affects the active local map. Returns -1 if none."""
        order = self.kf_slots_by_order()
        if len(order) <= exclude_recent + 1:
            return -1
        candidates = order[:-exclude_recent]
        slots, w = self.covisibility(self.newest_kf_slot)
        w_of = np.zeros((self.keyframes.valid.shape[0],), np.int64)
        w_of[slots] = w
        # Minimize (weight, order): np.lexsort-free via stable argsort.
        key = w_of[candidates] * 10**9 + self.keyframes.order[candidates]
        return int(candidates[np.argmin(key)])

    def kf_slots_by_order(self) -> np.ndarray:
        """Valid keyframe slots sorted oldest -> newest by insertion order."""
        kf = self.keyframes
        slots = np.nonzero(kf.valid)[0]
        return slots[np.argsort(kf.order[slots], kind="stable")]

    def n_keyframes(self) -> int:
        return int(self.keyframes.valid.sum())

    # ---- covisibility ----------------------------------------------------

    def covisibility(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Co-observation weights of keyframe `k` against every other valid
        keyframe (reference: KeyFrame::UpdateConnections counts shared
        MapPoints per KF pair, src/KeyFrame.cc / KeyFrame.h:135-158).

        Returns (slots (M,), weights (M,)) for other valid KFs, unsorted.
        One boolean-membership matvec over the flat observation tables —
        no pairwise KF loop.
        """
        kf = self.keyframes
        pid = kf.point_id[k]
        ov = kf.obs_valid[k] & (pid >= 0)
        flag = np.zeros((self.points.valid.shape[0],), bool)
        flag[pid[ov]] = True
        others = np.nonzero(kf.valid)[0]
        others = others[others != k]
        opid = kf.point_id[others]
        shared = kf.obs_valid[others] & (opid >= 0) & flag[np.maximum(opid, 0)]
        return others, shared.sum(axis=1).astype(np.int64)

    def covisible_kfs(self, k: int, min_weight: int = 15, cap: int = 0) -> np.ndarray:
        """Covisible neighbors of KF `k`, best-connected first (reference:
        GetVectorCovisibleKeyFrames / GetBestCovisibilityKeyFrames,
        include/KeyFrame.h:141-143). Falls back to the single best-connected
        KF when none clears `min_weight` (reference keeps at least the best
        edge, KeyFrame::UpdateConnections)."""
        slots, w = self.covisibility(k)
        if len(slots) == 0:
            return slots
        keep = w >= min_weight
        if not keep.any():
            keep = w == w.max()
            keep &= w > 0
        slots, w = slots[keep], w[keep]
        order = np.argsort(-w, kind="stable")
        slots = slots[order]
        return slots[:cap] if cap else slots

    # ---- points ----------------------------------------------------------

    def add_points(
        self,
        X_w: np.ndarray,
        desc: np.ndarray,
        normal: np.ndarray,
        octave: np.ndarray,
        frame_id: int,
        angle: np.ndarray | None = None,
    ) -> np.ndarray:
        """Append new map points; returns their slot ids (-1 where dropped)."""
        n = len(X_w)
        free = np.nonzero(~self.points.valid[self.next_point_slot :])[0]
        ids = np.full((n,), -1, np.int64)
        take = min(n, len(free))
        slots = self.next_point_slot + free[:take]
        ids[:take] = slots
        p = self.points
        p.X_w[slots] = X_w[:take]
        p.desc[slots] = desc[:take]
        p.normal[slots] = normal[:take]
        p.octave[slots] = octave[:take]
        if angle is not None:
            p.angle[slots] = angle[:take]
        p.valid[slots] = True
        p.n_obs[slots] = 0
        p.n_visible[slots] = 1
        p.n_found[slots] = 1
        p.first_kf[slots] = -1
        p.last_seen_frame[slots] = frame_id
        if take:
            self.next_point_slot = int(slots[-1]) + 1
        return ids

    # ---- lines -----------------------------------------------------------

    def add_lines(
        self, X0_w: np.ndarray, X1_w: np.ndarray, desc: np.ndarray, frame_id: int,
        first_kf: int = -1,
    ) -> np.ndarray:
        """Append new map lines; returns slot ids (-1 where dropped)."""
        n = len(X0_w)
        free = np.nonzero(~self.lines.valid[self.next_line_slot :])[0]
        ids = np.full((n,), -1, np.int64)
        take = min(n, len(free))
        slots = self.next_line_slot + free[:take]
        ids[:take] = slots
        t = self.lines
        t.X0_w[slots] = X0_w[:take]
        t.X1_w[slots] = X1_w[:take]
        t.desc[slots] = desc[:take]
        t.valid[slots] = True
        t.n_obs[slots] = 0
        t.n_visible[slots] = 1
        t.n_found[slots] = 1
        t.manh_idx[slots] = -1
        t.last_seen_frame[slots] = frame_id
        t.first_kf[slots] = first_kf
        if take:
            self.next_line_slot = int(slots[-1]) + 1
        return ids

    def add_kf_line_obs(
        self, kf_slot: int, line_id: np.ndarray, line2d: np.ndarray,
        obs_valid: np.ndarray,
        p0: np.ndarray | None = None, p1: np.ndarray | None = None,
        desc: np.ndarray | None = None, seg_valid: np.ndarray | None = None,
    ) -> None:
        kl = self.kf_lines
        kl.line_id[kf_slot] = line_id
        kl.line2d[kf_slot] = line2d
        kl.obs_valid[kf_slot] = obs_valid
        if p0 is not None:
            kl.p0[kf_slot] = p0
            kl.p1[kf_slot] = p1
            kl.desc[kf_slot] = desc
            kl.seg_valid[kf_slot] = seg_valid
        else:
            kl.seg_valid[kf_slot] = obs_valid
        ids = line_id[obs_valid & (line_id >= 0)]
        np.add.at(self.lines.n_obs, ids, 1)

    def cull_lines(self, current_frame: int) -> int:
        """(reference: LocalMapping::MapLineCulling, src/LocalMapping.cc:297)."""
        t = self.lines
        ratio = t.n_found / np.maximum(t.n_visible, 1)
        stale = (t.last_seen_frame < current_frame - 60) & (t.n_obs < 2)
        bad = t.valid & ((ratio < 0.25) | stale)
        t.valid[bad] = False
        return int(bad.sum())

    def local_kf_window(self, n_kfs: int) -> np.ndarray:
        """The tracking local-keyframe set: the newest KF plus its
        best-connected covisible neighbors (reference:
        Tracking::UpdateLocalKeyFrames, src/Tracking.cc:3652 — KFs sharing
        map points with the current frame, ranked by shared count)."""
        if self.newest_kf_slot < 0 or not self.keyframes.valid[self.newest_kf_slot]:
            return self.kf_slots_by_order()[-n_kfs:]
        k = self.newest_kf_slot
        neigh = self.covisible_kfs(k, min_weight=1, cap=max(n_kfs - 1, 0))
        return np.concatenate([[k], neigh]).astype(np.int64)

    def local_line_ids(self, n_recent_kfs: int, cap: int) -> np.ndarray:
        kl = self.kf_lines
        ks = self.local_kf_window(n_recent_kfs)
        lid = kl.line_id[ks]
        ok = kl.obs_valid[ks] & (lid >= 0)
        ids = np.unique(lid[ok])
        ids = ids[self.lines.valid[ids]]
        if len(ids) > cap:
            # Keep the best-observed lines, not an arbitrary slot suffix.
            rank = self.lines.n_obs[ids] * 1000 + self.lines.n_found[ids]
            ids = ids[np.argsort(-rank, kind="stable")[:cap]]
            ids.sort()
        return ids

    # ---- planes ----------------------------------------------------------

    def add_planes(
        self,
        pi_w: np.ndarray,
        centroid_w: np.ndarray,
        count: np.ndarray,
        frame_id: int,
        cov_w: np.ndarray | None = None,
        first_kf: int = -1,
    ) -> np.ndarray:
        n = len(pi_w)
        free = np.nonzero(~self.planes.valid)[0]
        ids = np.full((n,), -1, np.int64)
        take = min(n, len(free))
        slots = free[:take]
        ids[:take] = slots
        t = self.planes
        t.pi_w[slots] = pi_w[:take]
        t.centroid_w[slots] = centroid_w[:take]
        t.count[slots] = count[:take]
        t.valid[slots] = True
        t.n_obs[slots] = 0
        t.last_seen_frame[slots] = frame_id
        t.first_kf[slots] = first_kf
        # Seed the running moments from the first observation.
        w = count[:take].astype(np.float64)
        mu = centroid_w[:take].astype(np.float64)
        t.m_w[slots] = w
        t.m_sum[slots] = w[:, None] * mu
        c = (
            cov_w[:take].astype(np.float64)
            if cov_w is not None
            else np.zeros((take, 3, 3))
        )
        t.m_outer[slots] = w[:, None, None] * (
            c + mu[:, :, None] * mu[:, None, :]
        )
        return ids

    def update_plane_coefficients(
        self,
        plane_id: np.ndarray,  # (M,) map rows (deduplicated by caller or not)
        mu_w: np.ndarray,  # (M, 3) observation centroid, world frame
        cov_w: np.ndarray,  # (M, 3, 3) observation scatter about centroid
        count: np.ndarray,  # (M,) observation pixel weight
    ) -> None:
        """Fold fresh observations into the running moments and refit the
        plane coefficients (reference: MapPlane::UpdateCoefficientsAndPoints
        per matched frame plane, src/MapPlane.cc:337-372; the accumulated
        scatter replaces the merged voxel cloud, the eigh refit replaces the
        RANSAC re-segmentation)."""
        t = self.planes
        w = count.astype(np.float64)
        mu = mu_w.astype(np.float64)
        np.add.at(t.m_w, plane_id, w)
        np.add.at(t.m_sum, plane_id, w[:, None] * mu)
        np.add.at(
            t.m_outer,
            plane_id,
            w[:, None, None]
            * (cov_w.astype(np.float64) + mu[:, :, None] * mu[:, None, :]),
        )
        self._refit_planes(np.unique(plane_id))

    def _refit_planes(self, ids: np.ndarray) -> None:
        """Batched coefficient refit from accumulated moments (one np.eigh
        over all touched planes — no per-plane Python loop)."""
        t = self.planes
        ids = ids[t.m_w[ids] >= 1.0]
        if len(ids) == 0:
            return
        W = t.m_w[ids]
        mean = t.m_sum[ids] / W[:, None]
        C = t.m_outer[ids] / W[:, None, None] - mean[:, :, None] * mean[:, None, :]
        _, evecs = np.linalg.eigh(C + 1e-12 * np.eye(3)[None])
        n = evecs[:, :, 0]
        flip = np.sum(n * t.pi_w[ids, :3], axis=1) < 0  # orientation continuity
        n[flip] = -n[flip]
        t.pi_w[ids, :3] = n.astype(np.float32)
        t.pi_w[ids, 3] = (-np.sum(n * mean, axis=1)).astype(np.float32)
        t.centroid_w[ids] = mean.astype(np.float32)
        t.count[ids] = W.astype(np.float32)

    def add_kf_plane_obs(
        self, kf_slot: int, plane_id: np.ndarray, pi_obs: np.ndarray, obs_valid: np.ndarray
    ) -> None:
        kp = self.kf_planes
        kp.plane_id[kf_slot] = plane_id
        kp.pi_obs[kf_slot] = pi_obs
        kp.obs_valid[kf_slot] = obs_valid
        ids = plane_id[obs_valid & (plane_id >= 0)]
        np.add.at(self.planes.n_obs, ids, 1)

    def merge_planes(self, ang_th: float = 0.985, dist_th: float = 0.10) -> int:
        """Merge coplanar map planes (reference: MapPlaneCulling merge by
        angle + distance then Replace, src/LocalMapping.cc:2004).

        Vectorized: one pairwise angle/distance adjacency matrix, connected
        components by boolean matrix squaring, then an exact moments merge
        (moments are additive) and one batched refit — no O(P^2) Python loop.
        """
        t = self.planes
        ids = np.nonzero(t.valid)[0]
        n = len(ids)
        if n < 2:
            return 0
        normals = t.pi_w[ids, :3]
        dot = np.abs(normals @ normals.T)
        # d_ij = distance of centroid i to plane j (the reference tests the
        # candidate cloud against the landmark plane; symmetrize with OR).
        d_ij = np.abs(t.centroid_w[ids] @ normals.T + t.pi_w[ids, 3][None, :])
        adj = (dot > ang_th) & ((d_ij < dist_th) | (d_ij.T < dist_th))
        np.fill_diagonal(adj, True)
        if not (adj.sum() > n):
            return 0
        # Transitive closure by log-many boolean matrix squarings (P <= 256).
        reach = adj
        for _ in range(int(np.ceil(np.log2(n))) + 1):
            nxt = reach | (reach @ reach)
            if (nxt == reach).all():
                break
            reach = nxt
        root_pos = np.argmax(reach, axis=1)  # first reachable = min member
        is_root = root_pos == np.arange(n)
        merged_mask = ~is_root
        merged = int(merged_mask.sum())
        if merged == 0:
            return 0
        src, dst = ids[merged_mask], ids[root_pos[merged_mask]]
        np.add.at(t.m_w, dst, t.m_w[src])
        np.add.at(t.m_sum, dst, t.m_sum[src])
        np.add.at(t.m_outer, dst, t.m_outer[src])
        np.add.at(t.n_obs, dst, t.n_obs[src])
        t.valid[src] = False
        # Re-point keyframe observations at the survivors.
        lut = np.arange(t.valid.shape[0], dtype=np.int64)
        lut[src] = dst
        pid = self.kf_planes.plane_id
        mask = pid >= 0
        pid[mask] = lut[pid[mask]]
        self._refit_planes(np.unique(dst))
        return merged

    def cull_points(self, current_frame: int) -> int:
        """Drop low-quality points (reference: LocalMapping::MapPointCulling,
        src/LocalMapping.cc:260 — found/visible ratio < 0.25, or not observed
        by enough KFs shortly after creation)."""
        p = self.points
        ratio = p.n_found / np.maximum(p.n_visible, 1)
        stale = (p.last_seen_frame < current_frame - 60) & (p.n_obs < 2)
        bad = p.valid & ((ratio < 0.25) | stale)
        p.valid[bad] = False
        return int(bad.sum())

    def local_point_ids(self, n_recent_kfs: int, cap: int) -> np.ndarray:
        """Point slots observed by the covisible local-keyframe window
        (reference: Tracking::UpdateLocalPoints over UpdateLocalKeyFrames'
        set, src/Tracking.cc:3394,3652). Over capacity, the best-observed
        points survive — not an arbitrary slot suffix."""
        kf = self.keyframes
        ks = self.local_kf_window(n_recent_kfs)
        pid = kf.point_id[ks]
        ok = kf.obs_valid[ks] & (pid >= 0)
        ids = np.unique(pid[ok])
        ids = ids[self.points.valid[ids]]
        if len(ids) > cap:
            rank = self.points.n_obs[ids] * 1000 + self.points.n_found[ids]
            ids = ids[np.argsort(-rank, kind="stable")[:cap]]
            ids.sort()
        return ids
