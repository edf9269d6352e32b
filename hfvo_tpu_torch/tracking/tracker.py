"""Tracking state machine along the points path.

Port of `hfvo_tpu.tracking.tracker.Tracker` for the points-only
configuration (reference: `Tracking::Track`, src/Tracking.cc:619):
initialization from the first RGB-D frame, constant-velocity prediction,
one fused per-frame step (ORB extraction, BoW words, projection matching
against the local map, pose LM), the wide-window retry, the keyframe policy
and the host keyframe bookkeeping (fusion, descriptor re-election, culling),
and keyframe-relative trajectory chaining.

The per-frame step is one torch function on the tracker's device, and its
result comes back with one host synchronization. The JAX package's packed
wire format and pipelined (`track_rgbd_async`) path are transport
workarounds and are not ported. Stages outside this slice raise
`NotImplementedError` naming the slice that brings them.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..bow.database import KeyFrameDatabase
from ..bow.vocab import bow_histogram_np, compute_words
from ..config import VOConfig
from ..mapping.local_mapping import LocalMapper
from ..solve.lm import PoseObs, pose_optimization
from ..vomap.map import VOMap
from . import matcher
from .frontend import FrameFeatures, extract_frame


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


def check_slice(cfg: VOConfig, use_local_ba: bool, use_loop_closing: bool) -> None:
    """Raise NotImplementedError for anything outside the points-only slice."""
    out = [
        (cfg.use_lines, "use_lines", "the lines slice"),
        (cfg.use_planes, "use_planes", "the planes+Manhattan slice"),
        (cfg.use_manhattan, "use_manhattan", "the planes+Manhattan slice"),
        (use_local_ba, "use_local_ba", "the keyframe-path slice"),
        (cfg.tracking.triangulate_new_points, "tracking.triangulate_new_points",
         "the keyframe-path slice"),
        (cfg.tracking.triangulate_new_lines, "tracking.triangulate_new_lines",
         "the keyframe-path slice"),
        (use_loop_closing, "use_loop_closing", "the relocalization + loop slice"),
        (cfg.tracking.inv_sigma2_3d > 0, "tracking.inv_sigma2_3d > 0",
         "the relocalization + loop slice"),
        (cfg.tracking.static_mask_path is not None, "tracking.static_mask_path",
         "the facade + IO slice"),
    ]
    for on, name, where in out:
        if on:
            raise NotImplementedError(
                f"hfvo_tpu_torch runs the points-only slice; {name} arrives with "
                f"{where} (use config.points_only and use_local_ba=False, "
                "use_loop_closing=False)"
            )


class StepResult(NamedTuple):
    """Host copy of one fused step's result."""

    T_cw: np.ndarray  # (4, 4) float32
    inlier: np.ndarray  # (N,) bool
    n_inliers: int
    pt_local: np.ndarray  # (N,) snapshot row per keypoint or -1
    visible: np.ndarray  # (L,) bool
    feats: FrameFeatures  # numpy leaves
    words: np.ndarray  # (N,) BoW word ids


def _to_host(tensors):
    """Copy a sequence of tensors to host numpy with ONE synchronization:
    all device-to-host copies are queued non-blocking, then the stream is
    synchronized once."""
    dev = next((t.device for t in tensors if t.device.type == "cuda"), None)
    host = [t.to("cpu", non_blocking=True) if t.device.type == "cuda" else t for t in tensors]
    if dev is not None:
        torch.cuda.current_stream(dev).synchronize()
    return [t.numpy() for t in host]


def _feats_to_host(feats: FrameFeatures) -> FrameFeatures:
    out = _to_host(list(feats))
    return _host_feats(FrameFeatures(*out))


def _host_feats(f: FrameFeatures) -> FrameFeatures:
    """Host dtypes of the JAX package's per-frame features (uint32
    descriptor words, int32 octaves)."""
    return f._replace(desc=f.desc.astype(np.uint32), octave=f.octave.astype(np.int32))


def fused_track_step(
    cfg: VOConfig,
    gray_u8: torch.Tensor,  # (H, W) uint8
    depth_mm: torch.Tensor,  # (h, w) int32 millimetres, possibly subsampled
    map_X: torch.Tensor,  # (L, 3) local-map snapshot
    map_desc: torch.Tensor,  # (L, 8) int64 words
    map_valid: torch.Tensor,  # (L,) bool
    map_octave: torch.Tensor,  # (L,)
    map_angle: torch.Tensor,  # (L,) creation-keypoint IC angle
    map_normal: torch.Tensor,  # (L, 3) mean viewing direction (0 = ungated)
    T_pred: torch.Tensor,  # (4, 4)
    radius: float = 15.0,
    check_octave: bool = True,
):
    """The per-frame device work of the points path (the points part of
    hfvo_tpu/tracking/tracker.py::_fused_track_step_impl): extraction ->
    BoW words -> projection matching -> pose LM. Returns device tensors
    (T_cw, inlier, n_inliers, pt_local, visible, feats, words)."""
    gray = gray_u8.float()
    depth = depth_mm.float() * 1e-3
    if depth.shape[0] != gray.shape[0]:
        # Subsampled depth upload (TrackingConfig.depth_upload_stride):
        # nearest-upsample so every consumer keeps full-res geometry.
        s = -(-gray.shape[0] // depth.shape[0])
        dh, dw = depth.shape
        depth = depth[:, None, :, None].expand(dh, s, dw, s).reshape(dh * s, dw * s)
        depth = depth[: gray.shape[0], : gray.shape[1]]
    feats = extract_frame(gray, depth, cfg)
    words = compute_words(feats.desc)
    L = map_X.shape[0]
    tc = cfg.tracking
    res = matcher.search_by_projection(
        map_X, map_desc, map_valid,
        torch.arange(L, device=map_X.device), map_octave,
        feats.uv, feats.desc, feats.octave, feats.valid,
        T_pred, cfg.camera, radius=radius, check_octave=check_octave,
        map_angle=map_angle if tc.check_rotation_consistency else None,
        kp_angle=feats.angle if tc.check_rotation_consistency else None,
        map_normal=map_normal if tc.check_view_cos else None,
        view_cos_limit=tc.view_cos_limit,
    )
    pt_local = res.pt_id_per_kp
    pts = PoseObs(
        X_w=map_X[torch.clamp(pt_local, min=0)],
        obs=feats.obs,
        is_stereo=feats.depth > 1e-3,
        inv_sigma2=feats.inv_sigma2,
        valid=(pt_local >= 0) & feats.valid,
    )
    opt = pose_optimization(
        T_pred, pts, cfg.camera,
        chi2_mono=tc.chi2_mono, chi2_stereo=tc.chi2_stereo,
    )
    return opt.T_cw, opt.inlier, opt.n_inliers, pt_local, res.visible, feats, words


def _gray_u8(gray_np: np.ndarray) -> np.ndarray:
    """uint8 passthrough (the sensor/PNG format); clip + truncating cast of
    floats, as the JAX package uploads tracked frames."""
    if gray_np.dtype == np.uint8:
        return gray_np
    return np.clip(gray_np, 0, 255).astype(np.uint8)


@dataclass
class TrackResult:
    state: TrackState
    T_cw: np.ndarray
    n_matches: int
    is_keyframe: bool


@dataclass
class Tracker:
    cfg: VOConfig
    device: torch.device
    use_local_ba: bool = True
    use_loop_closing: bool = True
    vomap: VOMap = field(init=False)
    mapper: LocalMapper = field(init=False)
    state: TrackState = TrackState.NOT_INITIALIZED
    T_cw: np.ndarray = field(init=False)
    velocity: np.ndarray = field(init=False)  # T_cw_cur @ inv(T_cw_last)
    frame_id: int = -1
    last_kf_frame: int = -1
    n_matches_ref_kf: int = 0

    def __post_init__(self):
        check_slice(self.cfg, self.use_local_ba, self.use_loop_closing)
        self.device = torch.device(self.device)
        self.vomap = VOMap(self.cfg)
        self.mapper = LocalMapper(self.cfg, self.vomap)
        self.T_cw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self._snap = None
        self._snap_pad = None
        self._last_words = None  # (frame_id, word ids) from the fused step
        self._last_n_matches = 0
        # Per-stage accumulated wall times (reference: System::ExtractTimes,
        # src/System.cc:406-425): name -> [seconds, count].
        self.stage_times: dict = {}
        self.kf_db = KeyFrameDatabase(self.cfg.cap.keyframes)
        self.mapper._kf_db = self.kf_db
        # Per-frame (ref_kf_slot, T_cr) for keyframe-relative trajectory
        # chaining (reference: System::SaveTrajectoryTUM, src/System.cc:346).
        self._traj_rel: list = []

    def reset(self) -> None:
        """Full in-place reset: clear the map, database and tracking state
        (reference: Tracking::Reset, src/Tracking.cc:3923). Pre-reset
        trajectory entries are frozen into absolute poses and kept."""
        kf = self.vomap.keyframes
        frozen = [
            (-1, T_cr if ref < 0 else (T_cr @ kf.T_cw[ref]).astype(np.float32))
            for ref, T_cr in self._traj_rel
        ]
        saved_stages = self.stage_times
        fid = self.frame_id
        self.state = TrackState.NOT_INITIALIZED
        self.last_kf_frame = -1
        self.n_matches_ref_kf = 0
        self.__post_init__()
        self._traj_rel = frozen
        self.frame_id = fid
        self.stage_times = saved_stages

    def _stage(self, name: str, dt: float) -> None:
        acc = self.stage_times.setdefault(name, [0.0, 0])
        acc[0] += dt
        acc[1] += 1

    def stage_report(self) -> str:
        """Per-stage mean times (reference: System::ExtractTimes)."""
        return "\n".join(
            f"mean {k} time: {s / max(n, 1) * 1000:.2f} ms over {n} calls"
            for k, (s, n) in sorted(self.stage_times.items())
        )

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------

    def track_rgbd(
        self, gray: np.ndarray, depth: np.ndarray, T_cw_init: Optional[np.ndarray] = None
    ) -> TrackResult:
        """Process one RGB-D frame (reference: System::TrackRGBD ->
        Tracking::GrabImageRGBD_wh, src/Tracking.cc:236). `gray` is (H, W)
        intensity in [0, 255]; `depth` is float metres or uint16 mm."""
        self.frame_id += 1
        gray_np = np.asarray(gray)
        depth_np = np.asarray(depth)
        if self.state is TrackState.NOT_INITIALIZED:
            # Initialization extracts from float gray and full-resolution
            # float depth; tracked frames use the uint8 / uint16 uploads.
            t0 = time.perf_counter()
            gray_f = self._upload(gray_np.astype(np.float32))
            depth_f = self._upload(
                depth_np.astype(np.float32) * 1e-3
                if depth_np.dtype == np.uint16
                else depth_np.astype(np.float32)
            )
            feats = _feats_to_host(extract_frame(gray_f, depth_f, self.cfg))
            self._stage("init_extract", time.perf_counter() - t0)
            self._initialize(feats, T_cw_init)
            self._record_trajectory()
            return TrackResult(self.state, self.T_cw.copy(), 0, True)
        gray_u8 = self._upload(_gray_u8(gray_np))
        depth_mm = self._upload(self._depth_host_u16(depth_np).astype(np.int32))
        return self._track_prepared(gray_u8, depth_mm)

    def track_rgbd_async(self, gray, depth, T_cw_init=None):
        """The JAX package's pipelined (one-frame-lag) tracking hides a
        remote transport's round trip; it is not part of this slice."""
        raise NotImplementedError(
            "Tracker.track_rgbd_async arrives with the facade + IO slice; "
            "use track_rgbd"
        )

    def _track_prepared(self, gray, depth) -> TrackResult:
        T_pred = self.velocity @ self.T_cw
        if self.state is TrackState.LOST:
            raise NotImplementedError(
                "relocalization (Tracker._relocalize) arrives with the "
                "relocalization + loop slice"
            )
        return self._post_track(self._track_local_map(gray, depth, T_pred), gray, depth)

    def _post_track(self, five, gray, depth) -> TrackResult:
        """Everything after the primary step: the wide-window retry,
        pose/velocity update, keyframe policy, mapping, trajectory."""
        ok, T_new, pt_per_kp, n_matches, feats = five
        if not ok:
            # Wide-window recovery from the last pose (reference falls back
            # from the motion model to wider searches the same way).
            ok, T_new, pt_per_kp, n_matches, feats = self._track_local_map(
                gray, depth, self.T_cw, radius=50.0, check_octave=False
            )
        if not ok and int((feats.valid & (feats.depth > 1e-3)).sum()) >= 15:
            # Window-free fallback vs the reference keyframe (reference:
            # TrackReferenceKeyFrame, src/Tracking.cc:1831). With fewer than
            # 15 keypoints with depth it cannot reach its 15-match gate and
            # returns nothing, so only this branch needs it.
            raise NotImplementedError(
                "tracking failed after the wide-window retry; the reference-"
                "keyframe fallback (Tracker._track_reference_kf) arrives with "
                "the relocalization + loop slice"
            )
        is_kf = False
        if ok:
            vel = T_new @ np.linalg.inv(self.T_cw)
            self.velocity = vel.astype(np.float32)
            self.T_cw = T_new.astype(np.float32)
            self.state = TrackState.OK
            if self._need_new_keyframe(n_matches, feats, pt_per_kp):
                t0 = time.perf_counter()
                self._create_keyframe(feats, pt_per_kp)
                self._stage("kf_insert", time.perf_counter() - t0)
                # The ratio rule compares against the reference KF's tracked
                # matches (src/Tracking.cc:2966-2985).
                self.n_matches_ref_kf = max(n_matches, 1)
                is_kf = True
                t0 = time.perf_counter()
                self.mapper.fuse_points()
                self.mapper.reelect_point_descriptors()
                self._stage("kf_fuse", time.perf_counter() - t0)
                # Redundant-keyframe culling every few insertions
                # (reference: LocalMapping::KeyFrameCulling).
                if self.vomap.n_keyframes() % 4 == 0:
                    t0 = time.perf_counter()
                    self._reanchor_trajectory(self.mapper.cull_keyframes())
                    self._stage("kf_cull", time.perf_counter() - t0)
                self.invalidate_map_snapshot()
        else:
            self.state = TrackState.LOST
            # Auto-reset on early loss: with <= 5 keyframes the infant map is
            # rebuilt from scratch (reference: Tracking.cc:918-926).
            if self.vomap.n_keyframes() <= 5:
                self.reset()
        self._record_trajectory()
        return TrackResult(self.state, self.T_cw.copy(), n_matches, is_kf)

    # ------------------------------------------------------------------

    def _reanchor_trajectory(self, culled: list) -> None:
        """Re-chain trajectory entries referencing culled keyframes onto the
        nearest surviving keyframe (src/System.cc:372-401)."""
        if not culled:
            return
        vm = self.vomap
        surv = vm.kf_slots_by_order()
        surv = surv[~np.isin(surv, culled)]
        if len(surv) == 0:
            return
        kf = vm.keyframes
        refs = np.fromiter((r for r, _ in self._traj_rel), np.int64, len(self._traj_rel))
        for k in culled:
            hits = np.nonzero(refs == k)[0]
            if len(hits) == 0:
                continue
            j = int(surv[np.argmin(np.abs(kf.frame_id[surv] - kf.frame_id[k]))])
            D = (kf.T_cw[k] @ np.linalg.inv(kf.T_cw[j])).astype(np.float32)
            for i in hits:
                _, T_cr = self._traj_rel[i]
                self._traj_rel[i] = (j, (T_cr @ D).astype(np.float32))
            refs[hits] = j

    def _record_trajectory(self):
        ref = self.vomap.newest_kf_slot
        if ref < 0:
            self._traj_rel.append((-1, self.T_cw.copy()))
            return
        T_cr = self.T_cw @ np.linalg.inv(self.vomap.keyframes.T_cw[ref])
        self._traj_rel.append((int(ref), T_cr.astype(np.float32)))

    def get_trajectory(self) -> np.ndarray:
        """(F, 4, 4) camera-to-world poses, chained through the current
        keyframe poses (reference: src/System.cc:372-401)."""
        out = []
        for ref, T_cr in self._traj_rel:
            T_cw = T_cr if ref < 0 else T_cr @ self.vomap.keyframes.T_cw[ref]
            out.append(np.linalg.inv(T_cw))
        return np.stack(out)

    # ------------------------------------------------------------------

    def _initialize(self, feats: FrameFeatures, T_cw_init: Optional[np.ndarray]):
        """Create the first keyframe + map points from depth (reference:
        StereoInitialization, src/Tracking.cc:1350)."""
        if T_cw_init is not None:
            self.T_cw = T_cw_init.astype(np.float32)
        valid = feats.valid & (feats.depth > 1e-3)
        if valid.sum() < 50:
            return  # not enough depth to initialize
        self._create_keyframe(feats, np.full((self.cfg.cap.keypoints,), -1, np.int32))
        self.state = TrackState.OK
        self.last_kf_frame = self.frame_id

    def _depth_host_u16(self, depth_np: np.ndarray) -> np.ndarray:
        """Host-side compact depth: uint16 millimetres, subsampled by
        TrackingConfig.depth_upload_stride."""
        s = self.cfg.tracking.depth_upload_stride
        if s > 1:
            depth_np = depth_np[::s, ::s]
        if depth_np.dtype == np.uint16:
            return np.ascontiguousarray(depth_np)
        return np.clip(depth_np * 1000.0, 0, 65535).astype(np.uint16)

    def invalidate_map_snapshot(self):
        self._snap = None
        self._snap_pad = None

    def _local_map_snapshot(self):
        """Device-resident local-map snapshot, rebuilt only when the map
        changed (keyframe insertion / culling). Returns (tensors, pad) where
        `pad` maps snapshot rows to global point ids (-1 = empty row); it
        holds at most `cap.local_points` rows."""
        if self._snap is not None:
            return self._snap, self._snap_pad
        t0 = time.perf_counter()
        cap = self.cfg.cap.local_points
        ids = self.vomap.local_point_ids(self.cfg.tracking.local_map_size_kf, cap)
        # Rows past the last local point are empty (never visible, never
        # matched) in the JAX package's fixed-capacity snapshot, so they are
        # left out here; matches and conflict keys (distance, row) are
        # unchanged.
        pad = np.full((max(len(ids), 1),), -1, np.int64)
        pad[: len(ids)] = ids
        safe = np.maximum(pad, 0)
        p = self.vomap.points
        host = (
            p.X_w[safe],
            p.desc[safe].astype(np.int64),
            (pad >= 0) & p.valid[safe],
            p.octave[safe].astype(np.int64),
            p.angle[safe],
            p.normal[safe],
        )
        self._snap = tuple(self._upload(a) for a in host)
        self._snap_pad = pad
        self._stage("kf_snapshot", time.perf_counter() - t0)
        return self._snap, pad

    def _track_local_map(
        self,
        gray: torch.Tensor,
        depth: torch.Tensor,
        T_pred: np.ndarray,
        radius: float = 15.0,
        check_octave: bool = True,
    ):
        """Project the local map into the predicted view, match, optimize the
        pose (reference: TrackWithMotionModel + TrackLocalMap,
        src/Tracking.cc:2251, :2816) — one fused step, one host sync."""
        t0 = time.perf_counter()
        snap, pad = self._local_map_snapshot()
        T_pred_d = self._upload(np.asarray(T_pred, np.float32))
        T_cw, inlier, n_in, pt_local, visible, feats, words = fused_track_step(
            self.cfg, gray, depth, *snap, T_pred_d,
            radius=radius, check_octave=check_octave,
        )
        host = _to_host([T_cw, inlier, n_in, pt_local, visible, words, *feats])
        out = StepResult(
            T_cw=host[0], inlier=host[1], n_inliers=int(host[2]),
            pt_local=host[3], visible=host[4], words=host[5],
            feats=_host_feats(FrameFeatures(*host[6:])),
        )
        self._stage("fused_step", time.perf_counter() - t0)
        return self.finish_step(out, pad)

    def finish_step(self, out: StepResult, pad: np.ndarray):
        """Host bookkeeping for one pulled step result; returns
        (ok, T_cw, pt_per_kp, n_inliers, feats)."""
        self._last_words = (self.frame_id, out.words)
        n_in = out.n_inliers
        pt_local, inlier, T_new = out.pt_local, out.inlier, out.T_cw
        pt_per_kp = np.where(pt_local >= 0, pad[np.maximum(pt_local, 0)], -1)
        matched = pt_per_kp >= 0
        # Tracking bookkeeping (reference: MapPoint::IncreaseVisible/Found).
        vis_ids = pad[out.visible & (pad >= 0)]
        self.vomap.points.n_visible[vis_ids] += 1
        found_ids = pt_per_kp[matched & inlier]
        self.vomap.points.n_found[found_ids] += 1
        self.vomap.points.last_seen_frame[found_ids] = self.frame_id
        pt_per_kp = np.where(matched & inlier, pt_per_kp, -1).astype(np.int32)

        ok = n_in >= self.cfg.tracking.min_matches_track and np.isfinite(T_new).all()
        # A sudden match collapse (>75% drop vs the previous frame) means the
        # solution jumped basins even if the absolute count clears the gate.
        if ok and self._last_n_matches > 0 and n_in < 0.25 * self._last_n_matches:
            ok = False
        if ok:
            self._last_n_matches = n_in
        return ok, T_new.astype(np.float32), pt_per_kp, n_in, out.feats

    def _need_new_keyframe(self, n_matches: int, feats=None, pt_per_kp=None) -> bool:
        """(reference: Tracking::NeedNewKeyFrame, src/Tracking.cc:2923 —
        frame-gap rule, tracked-ratio rule vs the reference keyframe, and the
        RGB-D close-points condition, src/Tracking.cc:2966-2985)."""
        since = self.frame_id - self.last_kf_frame
        if since < max(self.cfg.tracking.min_frames_between_kf, 1):
            return False
        if since >= self.cfg.tracking.max_frames_between_kf:
            return True
        ratio_low = n_matches < 0.75 * max(self.n_matches_ref_kf, 1)
        need_close = False
        if feats is not None and pt_per_kp is not None:
            th_m = self.cfg.camera.bf * self.cfg.tracking.th_depth / self.cfg.camera.fx
            close = feats.valid & (feats.depth > 1e-3) & (feats.depth < th_m)
            tracked_close = int((close & (pt_per_kp >= 0)).sum())
            untracked_close = int((close & (pt_per_kp < 0)).sum())
            need_close = tracked_close < 100 and untracked_close > 70
        coverage_low = n_matches < self.cfg.tracking.min_coverage_kf
        return (ratio_low or need_close or coverage_low) and n_matches > 15

    def _create_keyframe(self, feats: FrameFeatures, pt_per_kp: np.ndarray):
        """Insert a keyframe; unmatched keypoints with depth become new map
        points (reference: Tracking::CreateNewKeyFrame, src/Tracking.cc:3032).
        `feats` holds host numpy arrays."""
        if self.vomap.kf_capacity_left() == 0:
            victim = self.vomap.weakest_kf()
            if victim >= 0:
                self._reanchor_trajectory([victim])
                self.vomap.release_keyframe(victim)
                self.kf_db.erase(victim)
        uv, depth, valid = feats.uv, feats.depth, feats.valid
        new_mask = valid & (depth > 1e-3) & (pt_per_kp < 0)
        idx = np.nonzero(new_mask)[0]
        if len(idx):
            cam = self.cfg.camera
            d_i = depth[idx]
            X_c = np.stack(
                [
                    (uv[idx, 0] - cam.cx) / cam.fx * d_i,
                    (uv[idx, 1] - cam.cy) / cam.fy * d_i,
                    d_i,
                ],
                axis=1,
            )
            T_wc = np.linalg.inv(self.T_cw)
            X_w = (T_wc[:3, :3] @ X_c.T).T + T_wc[:3, 3]
            normal = X_w - T_wc[:3, 3]
            normal /= np.linalg.norm(normal, axis=1, keepdims=True) + 1e-9
            ids = self.vomap.add_points(
                X_w.astype(np.float32), feats.desc[idx], normal.astype(np.float32),
                feats.octave[idx], self.frame_id, angle=feats.angle[idx],
            )
            pt_per_kp = pt_per_kp.copy()
            created = ids >= 0
            pt_per_kp[idx[created]] = ids[created]

        obs_valid = valid & (pt_per_kp >= 0)
        kf_slot = self.vomap.add_keyframe(
            self.T_cw, self.frame_id, pt_per_kp.astype(np.int32),
            feats.obs, feats.octave, feats.desc, obs_valid, kp_valid=valid,
        )
        # Appearance index (reference: KeyFrameDatabase::add). Words arrive
        # with the fused step; the init path computes them here.
        if self._last_words is not None and self._last_words[0] == self.frame_id:
            words = self._last_words[1]
        else:
            desc = self._upload(feats.desc.astype(np.int64))
            words = _to_host([compute_words(desc)])[0]
        self.kf_db.add(kf_slot, bow_histogram_np(words, valid))
        self.last_kf_frame = self.frame_id
        self.n_matches_ref_kf = int(obs_valid.sum())
        self.vomap.cull_points(self.frame_id)
