"""Tracking state machine: the tracking step and the keyframe path.

Port of `hfvo_tpu.tracking.tracker.Tracker` for the points-only, points +
lines and full (lines, planes and Manhattan axes) configurations
(reference: `Tracking::Track`, src/Tracking.cc:619): initialization from
the first RGB-D frame, constant-velocity prediction, one fused per-frame
step (with Manhattan axes, the mean-shift rotation prior and per-axis
anchors; ORB extraction, BoW words, projection matching against the local
map; with lines, Hough segments, 3D line fits, structural refinement, line
projection and frame-to-frame searches and flow-based line recovery; with
planes, plane segmentation and association; then the pose LM), the
wide-window retry, the reference-keyframe fallback, the keyframe policy,
the keyframe path (map points, lines and planes, the coarse and fine
Manhattan inits, epipolar point and two-view line triangulation, fusion,
descriptor re-election, local BA, loop closing, culling), relocalization
while LOST (BoW candidates, 3D-3D RANSAC, the depth-free PnP branch), the
early-loss reset, and keyframe-relative trajectory chaining. With
`tracking.inv_sigma2_3d > 0` the step adds the metric 3D point term, seeded
by a 3D-3D RANSAC.

The per-frame step is one torch function on the tracker's device, over a
leading sequence axis: a Tracker runs it at S = 1, and
`parallel.multiseq.BatchTracker` runs S sequences through one call. It is
split in two: `launch_fused_step` queues the step and the copies of its
result into host buffers and records one CUDA event, and
`collect_fused_step` waits on that event and splits the result per
sequence. `track_rgbd` is launch followed by collect; the pipelined
`track_rgbd_async` (hfvo_tpu/tracking/tracker.py:1054-1280) keeps up to
`pipeline_depth` launched frames in flight, each dispatched against a
constant-velocity prediction chained on the in-flight poses on the device,
and resolves them later. The JAX package's packed two-buffer wire format
and its on-device stacking of result groups are transport workarounds and
are not copied; which call returns which frames is the JAX package's. The
flow-based line recovery, a separate device program there, is an ordinary
call inside the step. The previous frame's segments and uint8 image stay on
the device between frames. A static feature mask
(`tracking.static_mask_path`) drops keypoints and segment midpoints in its
zero pixels on tracked frames, as the JAX package's step does.
"""
from __future__ import annotations

import enum
import math
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..bow.database import KeyFrameDatabase
from ..bow.vocab import bow_histogram, bow_histogram_np, compute_words
from ..config import VOConfig
from ..geometry import camera, se3
from ..io.tum import read_mask
from ..mapping.local_mapping import LocalMapper
from ..mapping.loop_closing import LoopCloser
from ..ops import lines as line_ops
from ..ops import lines3d, lk, structural
from ..ops import manhattan as manh_ops
from ..ops import planes as plane_ops
from ..ops import vp as vp_ops
from ..ops.batch import gather_pixels, resolve_device, take_rows, to_host
from ..solve.lm import DirObs, LineObs, PlaneObs, PoseObs, pose_optimization
from ..solve.pnp import pnp_ransac
from ..solve.ransac import ransac_rigid_3d3d
from ..vomap.map import VOMap
from . import matcher
from .frontend import FrameFeatures, extract_frame


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


class LineSnapshot(NamedTuple):
    """Device-resident local map lines (rows of the snapshot)."""

    X0: torch.Tensor  # (Ll, 3) world endpoints
    X1: torch.Tensor
    desc: torch.Tensor  # (Ll, D)
    valid: torch.Tensor  # (Ll,)


class LineFeed(NamedTuple):
    """The previous fused step's segments and uint8 image, kept on the
    device as the next step's frame-to-frame and flow-recovery input."""

    p0: torch.Tensor  # (Ml, 2)
    p1: torch.Tensor
    desc: torch.Tensor  # (Ml, D) float32
    valid: torch.Tensor  # (Ml,)
    gray: torch.Tensor  # (H, W) uint8


class LineStep(NamedTuple):
    """The line half of one fused step's result."""

    lf: line_ops.LineFeatures  # desc rounded through float16 (see below)
    l3d: lines3d.Lines3D
    ln_local: object  # (Ml,) snapshot row per segment or -1
    ln_inlier: object  # (Ml,) bool
    visible: object  # (Ll,) bool
    rec_rows: object  # (Ml,) snapshot row of each recovered previous segment or -1
    rec_inlier: object  # (Ml,) bool


class PlaneStep(NamedTuple):
    """The plane half of one fused step's result. The segmentation's
    per-block maps have no consumer and are left out (empty), as the JAX
    package leaves them out of its per-frame pull."""

    seg: plane_ops.PlaneSegmentation
    map_idx: object  # (P,) map-plane row of each observed plane or -1
    kind: object  # (P,) 0 full, 1 parallel, 2 vertical, -1 none
    inlier: object  # (P,) bool


class StepResult(NamedTuple):
    """Host copy of one fused step's result."""

    T_cw: np.ndarray  # (4, 4) float32
    inlier: np.ndarray  # (N,) bool
    n_inliers: int
    pt_local: np.ndarray  # (N,) snapshot row per keypoint or -1
    visible: np.ndarray  # (L,) bool
    feats: FrameFeatures  # numpy leaves
    words: np.ndarray  # (N,) BoW word ids
    lines: Optional[LineStep] = None  # numpy leaves; None without lines
    planes: Optional[PlaneStep] = None  # numpy leaves; None without planes
    manh: Optional[tuple] = None  # (measured axes (3, 3), supports (3,)); None without Manhattan


def _unit(d: torch.Tensor) -> torch.Tensor:
    return d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-9)


def _manhattan_prior(cfg: VOConfig, depth, T_pred, R_wm, manh_valid):
    """The Manhattan block of the fused step (hfvo_tpu/tracking/tracker.py:
    119-171, reference: TrackManhattanFrame before motion-model tracking,
    src/Tracking.cc:706), on a leading sequence axis. The frame's stride-8
    normals mean-shift the predicted axes R_cw R_wm; the refined rotation
    replaces the predicted one when two axes are well supported and the
    correction is small, and each measured axis becomes a rotation anchor of
    the LM. Returns (T_pred, refined R_cm, axes_c, axes_w, w_axis, supports)."""
    mc = cfg.manhattan
    normals, n_ok = plane_ops.compute_normals(depth, cfg.camera, stride=8)
    R_pred = T_pred[..., :3, :3]
    R_cm_pred = R_pred @ R_wm
    # One mean-shift step: measure_axes is refine_axes' first half on the
    # same input, so its rows and supports serve both.
    A_meas, sup = manh_ops.measure_axes(R_cm_pred, normals, n_ok.float(),
                                        cone=mc.normal_cone, kernel=mc.meanshift_kernel)
    R_cm_ref = manh_ops.complete_axes(A_meas, sup)
    enough = manh_valid & (torch.sum(sup > 30, dim=-1) >= 2)
    R_prior = R_cm_ref @ R_wm.transpose(-1, -2)
    # A drift-correcting refinement, not a replacement: a mean shift that
    # jumped basins (a wrong axis lock) keeps the motion model.
    tr = torch.diagonal(R_prior @ R_pred.transpose(-1, -2), dim1=-2, dim2=-1).sum(-1)
    use = enough & (0.5 * (tr - 1.0) > math.cos(0.02))
    T_prior = T_pred.clone()
    T_prior[..., :3, :3] = R_prior
    T_pred = torch.where(use[..., None, None], T_prior, T_pred)
    # Per-axis anchors from the raw measurements (no joint
    # orthonormalization), each gated on its support and a plausible
    # correction.
    cos_ax = torch.sum(A_meas * R_cm_pred.transpose(-1, -2), dim=-1)
    ok = manh_valid[..., None] & (sup >= mc.rot_prior_min_support) \
        & (cos_ax > math.cos(mc.rot_prior_max_correction))
    w_raw = mc.rot_prior_weight * sup.float()
    w_sat = w_raw / (1.0 + w_raw * mc.rot_prior_bias ** 2)
    w_axis = torch.where(ok, w_sat, 0.0)
    return T_pred, R_cm_ref, A_meas, R_wm.transpose(-1, -2), w_axis, sup


def _plane_edges(cfg: VOConfig, depth, mp_pi, mp_valid, T_pred):
    """The plane block of the fused step (hfvo_tpu/tracking/tracker.py:
    418-448), on a leading sequence axis: segment the frame's planes,
    associate them with the map planes and build the plane edges. Returns
    (PlaneObs, segmentation, PlaneMatchResult)."""
    pc = cfg.planes
    seg = plane_ops.segment_planes(depth, cfg.camera, max_planes=cfg.cap.planes)
    pres = matcher.match_planes(
        mp_pi, mp_valid, seg.planes, seg.centroids, seg.valid, T_pred,
        ang_ref=pc.association_ang_ref, dis_ref=pc.association_dis_ref,
    )
    kind = torch.clamp(pres.kind, min=0)
    table = torch.tensor(
        [[pc.angle_info, pc.angle_info, pc.distance_info],
         [pc.parallel_info, 0.0, 0.0],
         [pc.vertical_info, 0.0, 0.0]], device=depth.device,
    )
    pobs = PlaneObs(
        pi_w=take_rows(mp_pi, torch.clamp(pres.map_idx, min=0)),
        pi_obs=seg.planes,
        kind=kind,
        weight=table[kind],
        chi2_th=torch.where(kind == 0, pc.chi, pc.vp_chi),
        valid=seg.valid & (pres.kind >= 0),
    )
    return pobs, seg, pres


def _in_mask(mask, uv):
    """Whether pixel positions uv (*B, N, 2) fall in the static mask's
    usable region (*B, H, W) bool, at the truncated and clipped pixel (the
    JAX package's int32 cast, hfvo_tpu/tracking/tracker.py:177-179)."""
    H, W = mask.shape[-2:]
    u = torch.clamp(uv[..., 0].to(torch.int64), 0, W - 1)
    v = torch.clamp(uv[..., 1].to(torch.int64), 0, H - 1)
    return gather_pixels(mask, v, u)


def _line_edges(cfg: VOConfig, gray, depth, snap: LineSnapshot, feed: LineFeed,
                prev_row, T_pred, T_prev, manh=None, static_mask=None):
    """The line block of the fused step (hfvo_tpu/tracking/tracker.py:
    239-408), on a leading sequence axis. `manh` is (refined R_cm,
    manh_valid) with Manhattan axes, else None; `static_mask` (S, H, W)
    drops segments whose midpoint it masks. Returns (LineObs, DirObs,
    partial LineStep on the device, rec_ok, feed of this frame's segments
    without its image)."""
    cam = cfg.camera
    lc = cfg.lines
    lf = line_ops.detect_lines(gray, capacity=cfg.cap.lines)
    if static_mask is not None:
        lf = lf._replace(valid=lf.valid & _in_mask(static_mask, 0.5 * (lf.p0 + lf.p1)))
    l3d = lines3d.fit_lines_3d(
        depth, cam, lf.p0, lf.p1, lf.valid,
        min_valid=lc.min_valid_depth_samples, min_length=lc.min_length_3d,
    )
    # Structural endpoint refinement (reference: par/perp discovery,
    # src/Tracking.cc:270-293, then LineOptStruct, src/Tracking.cc:331).
    v3 = lf.valid & l3d.valid
    d3 = _unit(l3d.X1_c - l3d.X0_c)
    pairs = structural.discover_pairs(
        _unit(lf.p1 - lf.p0), d3, v3,
        par_deg=cfg.manhattan.par_deg_2d3d, perp_deg=cfg.manhattan.perp_deg_2d3d,
    )
    if manh is not None:
        # Lines along a Manhattan axis are pulled onto it.
        R_cm, manh_valid = manh
        ax_idx = manh_ops.line_axis_assignment(R_cm, d3, cone=cfg.manhattan.line_cone)
        ax_dir = take_rows(R_cm.transpose(-1, -2), torch.clamp(ax_idx, min=0))
        ax_ok = (ax_idx >= 0) & manh_valid[..., None] & v3
    else:
        ax_dir = torch.zeros_like(d3)
        ax_ok = torch.zeros_like(v3)
    # Frame-vs-map pairs: map directions rotated into the camera by the
    # prediction are fixed measurements (src/Manhattan.cpp:163-214).
    ml_d_w = snap.X1 - snap.X0
    ml_len = torch.linalg.norm(ml_d_w, dim=-1, keepdim=True)
    ml_d_w = ml_d_w / torch.clamp(ml_len, min=1e-9)
    ml_dvalid = snap.valid & (ml_len[..., 0] > 1e-3)
    R_pred = T_pred[..., :3, :3]
    par_map, perp_map = structural.discover_pairs_vs_map(
        d3 @ R_pred, v3, ml_d_w, ml_dvalid,
        par_deg=cfg.manhattan.par_deg_map, perp_deg=cfg.manhattan.perp_deg_map,
    )
    X0r, X1r = structural.line_opt_struct(
        l3d.X0_c, l3d.X1_c, v3, pairs.par, pairs.perp, ax_dir, ax_ok,
        map_dir=ml_d_w @ R_pred.transpose(-1, -2), par_map=par_map, perp_map=perp_map,
    )
    l3d = l3d._replace(X0_c=X0r, X1_c=X1r)
    lres = matcher.search_lines_by_projection(
        snap.X0, snap.X1, snap.desc, snap.valid,
        lf.p0, lf.p1, lf.desc, lf.valid, T_pred, cam,
    )
    ln_local = lres.pt_id_per_kp

    # Frame-to-frame search: segments the projection search left unmatched
    # inherit the previous frame's map-line match when descriptor and
    # rotation-warped geometry agree (src/LSDmatcher.cpp:36-156).
    Ml = lf.p0.shape[-2]
    batch = gray.shape[:-2]
    dev = gray.device
    R_cl = T_pred[..., :3, :3] @ T_prev[..., :3, :3].transpose(-1, -2)
    w0 = lk.warp_points_by_rotation(cam, feed.p0, R_cl)
    w1 = lk.warp_points_by_rotation(cam, feed.p1, R_cl)
    cand = feed.valid & (prev_row >= 0)
    f2f = matcher.search_lines_f2f(
        w0, w1, feed.desc, cand, lf.p0, lf.p1, lf.desc, lf.valid,
        max_desc_dist=lc.f2f_max_desc_dist, max_mid_dist=lc.f2f_max_mid_dist,
        max_angle=lc.f2f_max_angle,
    )
    inherit = (ln_local < 0) & (f2f.pt_id_per_kp >= 0)
    inherited = torch.gather(prev_row, -1, torch.clamp(f2f.pt_id_per_kp, min=0))
    ln_local = torch.where(inherit, inherited, ln_local)
    lmatched = ln_local >= 0
    safe = torch.clamp(ln_local, min=0)
    line2d = lf.line2d

    # Flow-based recovery of previous segments whose map line found no
    # match above, verified against the projected map line
    # (src/LSDmatcher.cpp:158-520, :420-470).
    Ll = snap.X0.shape[-2]
    row_matched = torch.zeros(batch + (Ll + 1,), dtype=torch.bool, device=dev)
    row_matched.scatter_(-1, torch.where(lmatched, safe, torch.full_like(safe, Ll)), True)
    row_matched = row_matched[..., :Ll]
    prow_safe = torch.clamp(prev_row, min=0)
    prev_X0, prev_X1 = take_rows(snap.X0, prow_safe), take_rows(snap.X1, prow_safe)
    if lc.lk_recovery:
        need = cand & ~torch.gather(row_matched, -1, prow_safe)
        q0, q1, rec_fit = lk.recover_lines_by_flow(
            cam, feed.gray.float(), gray, feed.p0, feed.p1, cand, R_cl,
            n_pts=lc.lk_samples,
        )
        P0c = se3.transform(T_pred[..., None, :, :], prev_X0)
        P1c = se3.transform(T_pred[..., None, :, :], prev_X1)
        pr0 = camera.project(cam, P0c)
        pr1 = camera.project(cam, P1c)
        dirm = pr1 - pr0
        lenm = torch.linalg.norm(dirm, dim=-1) + 1e-9
        um = dirm / lenm[..., None]
        nm = torch.stack([-um[..., 1], um[..., 0]], dim=-1)
        front = (P0c[..., 2] > 0.1) & (P1c[..., 2] > 0.1)
        dperp = torch.maximum(
            torch.abs(torch.sum((q0 - pr0) * nm, dim=-1)),
            torch.abs(torch.sum((q1 - pr0) * nm, dim=-1)),
        )
        dq = q1 - q0
        lenq = torch.linalg.norm(dq, dim=-1) + 1e-9
        cosang = torch.abs(torch.sum(dq * um, dim=-1)) / lenq
        rec_ok = (
            need & rec_fit & front
            & (dperp < lc.lk_max_perp)
            & (cosang > math.cos(lc.lk_max_angle))
            & (lenq > 10.0)
        )
        # Homogeneous 2D line through the recovered endpoints, normalized
        # like LineFeatures.line2d.
        one = torch.ones_like(q0[..., :1])
        rl = torch.linalg.cross(torch.cat([q0, one], dim=-1), torch.cat([q1, one], dim=-1), dim=-1)
        rl = rl / (torch.linalg.norm(rl[..., :2], dim=-1, keepdim=True) + 1e-9)
        rec_rows = torch.where(rec_ok, prev_row, torch.full_like(prev_row, -1))
    else:
        rec_ok = torch.zeros_like(feed.valid)
        rl = torch.zeros(batch + (Ml, 3), device=dev)
        rec_rows = torch.full_like(prev_row, -1)

    X0m, X1m = take_rows(snap.X0, safe), take_rows(snap.X1, safe)
    Mr = rec_ok.shape[-1]
    lobs = LineObs(
        X_w=torch.cat([X0m, X1m, prev_X0, prev_X1], dim=-2),
        line2d=torch.cat([line2d, line2d, rl, rl], dim=-2),
        inv_sigma2=torch.ones(batch + (2 * Ml + 2 * Mr,), device=dev),
        valid=torch.cat([lmatched & lf.valid, lmatched & lf.valid, rec_ok, rec_ok], dim=-1),
    )
    # Vanishing-point direction edges: the matched map line's world
    # direction against the refined 3D observation (src/Optimizer.cc:820-860).
    dml = X1m - X0m
    dml_n = torch.linalg.norm(dml, dim=-1, keepdim=True)
    dobs = DirObs(
        d_w=dml / torch.clamp(dml_n, min=1e-9),
        d_c=_unit(l3d.X1_c - l3d.X0_c),
        inv_sigma2=torch.ones(batch + (Ml,), device=dev),
        valid=lmatched & v3 & (dml_n[..., 0] > 1e-3),
    )
    # What a tracked frame passes on, to its keyframe and to the next
    # frame's feed, carries the descriptors rounded through float16: the
    # JAX package rounds its per-frame result for the host wire
    # (hfvo_tpu/tracking/tracker.py:469-475), keyframe insertion stores that
    # copy, and its float32 device feed is cast back from it (:533). A
    # semantic of the reference, not a wire format here.
    lf_out = lf._replace(desc=lf.desc.half().float())
    part = LineStep(lf_out, l3d, ln_local, None, lres.visible, rec_rows, None)
    return lobs, dobs, part, rec_ok, (lf.p0, lf.p1, lf_out.desc, lf.valid)


def _metric_3d(cfg: VOConfig, feats: FrameFeatures, pts: PoseObs, T_pred):
    """The metric 3D block of the fused step (hfvo_tpu/tracking/tracker.py:
    207-237), on a leading sequence axis: the depth-measured camera points
    join the LM's point edges; a 3D-3D RANSAC over the matched pairs (seed
    7, 5 cm, 25 inliers) picks the majority alignment, seeds the LM with it
    and restricts the 3D edges to its inliers (slid matches on repetitive
    stripes have a near-zero image residual but a lattice-sized 3D error).
    The draw and the choice stay on the device. Returns (LM start, PoseObs)."""
    has_depth = feats.depth > 1e-3
    X_c = camera.unproject(cfg.camera, feats.uv, torch.clamp(feats.depth, min=1e-3))
    r3 = ransac_rigid_3d3d(pts.X_w, X_c, pts.valid & has_depth, 7, inlier_th=0.05, min_inliers=25)
    T_cons = se3.inv(r3.T_ab)
    use = r3.ok & torch.isfinite(T_cons).flatten(-2).all(-1)
    T_lm0 = torch.where(use[..., None, None], T_cons, T_pred)
    valid_3d = has_depth & torch.where(r3.ok[..., None], r3.inliers, torch.ones_like(r3.inliers))
    return T_lm0, pts._replace(X_c_obs=X_c, valid_3d=valid_3d)


def _feats_to_host(feats: FrameFeatures) -> FrameFeatures:
    out = to_host(list(feats))
    return _host_feats(FrameFeatures(*out))


def _host_feats(f: FrameFeatures) -> FrameFeatures:
    """Host dtypes of the JAX package's per-frame features (uint32
    descriptor words, int32 octaves)."""
    return f._replace(desc=f.desc.astype(np.uint32), octave=f.octave.astype(np.int32))


def fused_track_step(
    cfg: VOConfig,
    gray_u8: torch.Tensor,  # (S, H, W) uint8
    depth_mm: torch.Tensor,  # (S, h, w) int32 millimetres, possibly subsampled
    map_X: torch.Tensor,  # (S, L, 3) local-map snapshot
    map_desc: torch.Tensor,  # (S, L, 8) int64 words
    map_valid: torch.Tensor,  # (S, L) bool
    map_octave: torch.Tensor,  # (S, L)
    map_angle: torch.Tensor,  # (S, L) creation-keypoint IC angle
    map_normal: torch.Tensor,  # (S, L, 3) mean viewing direction (0 = ungated)
    T_pred: torch.Tensor,  # (S, 4, 4)
    radius: float = 15.0,
    check_octave: bool = True,
    line_snap: Optional[LineSnapshot] = None,  # (S, Ll, ...) with cfg.use_lines
    line_feed: Optional[LineFeed] = None,  # previous frames' segments, (S, Ml, ...)
    prev_row: Optional[torch.Tensor] = None,  # (S, Ml) feed segment's snapshot row or -1
    T_prev: Optional[torch.Tensor] = None,  # (S, 4, 4) previous frames' poses
    mp_pi: Optional[torch.Tensor] = None,  # (S, Lp, 4) map planes, with cfg.use_planes
    mp_valid: Optional[torch.Tensor] = None,  # (S, Lp)
    R_wm: Optional[torch.Tensor] = None,  # (S, 3, 3) world Manhattan axes, with cfg.use_manhattan
    manh_valid: Optional[torch.Tensor] = None,  # (S,) bool Manhattan frame initialized
    static_mask: Optional[torch.Tensor] = None,  # (S, H, W) bool usable region, with a mask file
):
    """The per-frame device work of S independent sequences at once
    (hfvo_tpu/tracking/tracker.py::_fused_track_step_impl, vmapped as
    hfvo_tpu/parallel/multiseq.py does): with Manhattan axes, the rotation
    prior and axis anchors -> extraction -> BoW words -> projection
    matching -> with lines, the line block -> with planes, the plane block
    -> pose LM. Every input and output has a leading sequence axis; a single
    tracker runs S = 1. Returns device tensors (T_cw, inlier, n_inliers,
    pt_local, visible, feats, words, lines, planes, manh): `lines` is None
    without lines, else (LineStep, this frame's (p0, p1, desc, valid) for
    the next feed); `planes` is None without planes, else a PlaneStep;
    `manh` is None without Manhattan axes, else (measured axes, supports)."""
    gray = gray_u8.float()
    depth = depth_mm.float() * 1e-3
    H, W = gray.shape[-2:]
    if depth.shape[-2] != H:
        # Subsampled depth upload (TrackingConfig.depth_upload_stride):
        # nearest-upsample so every consumer keeps full-res geometry.
        s = -(-H // depth.shape[-2])
        S, dh, dw = depth.shape
        depth = depth[:, :, None, :, None].expand(S, dh, s, dw, s).reshape(S, dh * s, dw * s)
        depth = depth[:, :H, :W]
    manh = axes = None
    if cfg.use_manhattan:
        T_pred, R_cm_ref, axes_c, axes_w, w_axis, sup = _manhattan_prior(
            cfg, depth, T_pred, R_wm, manh_valid
        )
        manh = (R_cm_ref, manh_valid)
        axes = dict(axes_c=axes_c, axes_w=axes_w, w_axis=w_axis)
    feats = extract_frame(gray, depth, cfg)
    if static_mask is not None:
        # Exclude features in masked (dynamic) regions, like the reference's
        # detector mask (src/Tracking.cc:82-86).
        feats = feats._replace(valid=feats.valid & _in_mask(static_mask, feats.uv))
    words = compute_words(feats.desc)
    L = map_X.shape[-2]
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
        X_w=take_rows(map_X, torch.clamp(pt_local, min=0)),
        obs=feats.obs,
        is_stereo=feats.depth > 1e-3,
        inv_sigma2=feats.inv_sigma2,
        valid=(pt_local >= 0) & feats.valid,
    )
    T_lm0 = T_pred
    if tc.inv_sigma2_3d > 0:
        T_lm0, pts = _metric_3d(cfg, feats, pts, T_pred)
    lobs = dobs = pobs = None
    if cfg.use_lines:
        lobs, dobs, part, rec_ok, seg = _line_edges(
            cfg, gray, depth, line_snap, line_feed, prev_row, T_pred, T_prev, manh, static_mask
        )
    if cfg.use_planes:
        pobs, pseg, pres = _plane_edges(cfg, depth, mp_pi, mp_valid, T_pred)
    opt = pose_optimization(
        T_lm0, pts, cfg.camera, lines=lobs, planes=pobs, dirs=dobs, **(axes or {}),
        chi2_mono=tc.chi2_mono, chi2_stereo=tc.chi2_stereo, chi2_line=tc.chi2_line,
        chi2_3d=tc.chi2_3d, inv_sigma2_3d=tc.inv_sigma2_3d,
    )
    line_out = plane_out = manh_out = None
    if cfg.use_lines:
        M, Mr = part.ln_local.shape[-1], rec_ok.shape[-1]
        li = opt.line_inlier
        part = part._replace(
            ln_inlier=li[..., :M] & li[..., M : 2 * M],
            rec_inlier=li[..., 2 * M : 2 * M + Mr] & li[..., 2 * M + Mr :] & rec_ok,
        )
        line_out = (part, seg)
    if cfg.use_planes:
        plane_out = PlaneStep(pseg, pres.map_idx, pres.kind, opt.plane_inlier)
    if cfg.use_manhattan:
        # The measured axes go to the keyframe, as local BA's per-keyframe
        # rotation anchors.
        manh_out = (axes["axes_c"], sup)
    return (opt.T_cw, opt.inlier, opt.n_inliers, pt_local, res.visible, feats, words,
            line_out, plane_out, manh_out)


class StepArgs(NamedTuple):
    """One sequence's inputs of the fused step besides its images: device
    tensors without the sequence axis, and the host maps of its snapshot
    rows (`pad`, `lpad`: global point / line id per row, -1 = empty)."""

    snap: tuple  # (X, desc, valid, octave, angle, normal), (L, ...) each
    T_pred: torch.Tensor  # (4, 4)
    pad: np.ndarray
    line_snap: Optional[LineSnapshot] = None
    feed: Optional[LineFeed] = None
    prev_row: Optional[torch.Tensor] = None  # (Ml,)
    T_prev: Optional[torch.Tensor] = None
    lpad: Optional[np.ndarray] = None
    planes: Optional[tuple] = None  # (mp_pi (Lp, 4), mp_valid (Lp,)) with planes
    manh: Optional[tuple] = None  # (R_wm (3, 3), manh_valid ()) with Manhattan axes
    mask: Optional[torch.Tensor] = None  # (H, W) bool static mask, with a mask file


def _stack_rows(rows) -> torch.Tensor:
    """Stack (L_s, ...) tensors into (S, max L_s, ...), padding the shorter
    with zero rows at the end (zero = invalid, never matched): the JAX
    package's fixed-capacity layout, which leaves the conflict keys
    (distance, row) of every sequence unchanged."""
    if len(rows) == 1:
        return rows[0][None]
    n = max(r.shape[0] for r in rows)
    out = rows[0].new_zeros((len(rows), n) + tuple(rows[0].shape[1:]))
    for i, r in enumerate(rows):
        out[i, : r.shape[0]] = r
    return out


class LaunchedStep(NamedTuple):
    """One launched fused step of S sequences: the host copies of its
    result (pinned on the card, each launch its own, filled by non-blocking
    copies), the CUDA event recorded after the copies (None on the CPU), and
    what `collect_fused_step` needs to split them."""

    host: list  # host copies of the result's tensors
    event: Optional[torch.cuda.Event]
    layout: tuple  # (n_main, n_lines, n_planes, n_manh): offsets into `host`, None if absent
    seg: Optional[tuple]  # (p0, p1, desc, valid) on the device, the next line feed
    gray_u8: torch.Tensor  # (S, H, W) uint8, the next line feed's image
    args: list  # S StepArgs
    T_cw: torch.Tensor  # (S, 4, 4) device poses, for predictions chained on them


def _queue_step(cfg: VOConfig, gray_u8, depth_mm, args, radius, check_octave):
    """Queue one fused step for S sequences. Returns the result's device
    tensors in the order `collect_fused_step` reads their host copies, their
    layout (n_main, n_lines, n_planes, n_manh: offsets, None if absent), the
    next line feed's segments and the (S, 4, 4) device poses."""
    kw = {}
    if cfg.use_lines:
        kw.update(
            line_snap=LineSnapshot(*(_stack_rows([a.line_snap[j] for a in args]) for j in range(4))),
            line_feed=LineFeed(*(torch.stack([a.feed[j] for a in args]) for j in range(5))),
            prev_row=torch.stack([a.prev_row for a in args]),
            T_prev=torch.stack([a.T_prev for a in args]),
        )
    if cfg.use_planes:
        kw.update(mp_pi=torch.stack([a.planes[0] for a in args]),
                  mp_valid=torch.stack([a.planes[1] for a in args]))
    if cfg.use_manhattan:
        kw.update(R_wm=torch.stack([a.manh[0] for a in args]),
                  manh_valid=torch.stack([a.manh[1] for a in args]))
    if args[0].mask is not None:
        kw.update(static_mask=torch.stack([a.mask for a in args]))
    snap = [_stack_rows([a.snap[j] for a in args]) for j in range(6)]
    T_cw, inlier, n_in, pt_local, visible, feats, words, line_out, plane_out, manh_out = fused_track_step(
        cfg, gray_u8, depth_mm, *snap, torch.stack([a.T_pred for a in args]),
        radius=radius, check_octave=check_octave, **kw,
    )
    n_main = 6 + len(feats)
    pulled = [T_cw, inlier, n_in, pt_local, visible, words, *feats]
    n_lines = n_planes = n_manh = seg = None
    if line_out is not None:
        part, seg = line_out
        n_lines = len(pulled)
        pulled += [*part.lf, *part.l3d, *part[2:]]
    if plane_out is not None:
        n_planes = len(pulled)
        ps = plane_out.seg
        pulled += [ps.planes, ps.centroids, ps.counts, ps.valid, ps.covs, *plane_out[1:]]
    if manh_out is not None:
        n_manh = len(pulled)
        pulled += list(manh_out)
    return pulled, (n_main, n_lines, n_planes, n_manh), seg, T_cw


def launch_fused_step(
    cfg: VOConfig,
    gray_u8: torch.Tensor,  # (S, H, W) uint8
    depth_mm: torch.Tensor,  # (S, h, w) int32
    args,  # S StepArgs
    radius: float = 15.0,
    check_octave: bool = True,
) -> LaunchedStep:
    """Queue one fused step for S sequences and the copies of its result
    into host buffers, and record one event after them. Returns without
    waiting for the device, apart from the host synchronizations inside the
    step itself (the pose LM's convergence test)."""
    pulled, layout, seg, T_cw = _queue_step(cfg, gray_u8, depth_mm, args, radius, check_octave)
    event = None
    if gray_u8.device.type == "cuda":
        # `.to("cpu", non_blocking=True)` from the card fills a new pinned
        # buffer; the event marks the copies' end.
        host = [t.to("cpu", non_blocking=True) for t in pulled]
        event = torch.cuda.Event()
        event.record()
    else:
        host = pulled
    return LaunchedStep(host, event, layout, seg, gray_u8, list(args), T_cw)


def collect_fused_step(step: LaunchedStep):
    """Wait for a launched step's host copies and split them per sequence.
    Returns, per sequence, (StepResult, LineFeed of this frame on the
    device or None)."""
    if step.event is not None:
        step.event.synchronize()
    host = [t.numpy() for t in step.host]
    n_main, n_lines, n_planes, n_manh = step.layout
    out = []
    for s, a in enumerate(step.args):
        h = [x[s] for x in host]
        lines_host = feed = planes_host = manh_host = None
        if n_lines is not None:
            lh = h[n_lines:]
            lines_host = LineStep(
                line_ops.LineFeatures(*lh[:6]), lines3d.Lines3D(*lh[6:9]), lh[9], lh[10],
                lh[11][: len(a.lpad)], lh[12], lh[13],
            )
            feed = LineFeed(*(t[s] for t in step.seg), step.gray_u8[s])
        if n_planes is not None:
            planes_host = _host_plane_step(*h[n_planes:n_planes + 8])
        if n_manh is not None:
            manh_host = (h[n_manh], h[n_manh + 1])
        res = StepResult(
            T_cw=h[0], inlier=h[1], n_inliers=int(h[2]), pt_local=h[3],
            visible=h[4][: len(a.pad)], words=h[5],
            feats=_host_feats(FrameFeatures(*h[6:n_main])), lines=lines_host,
            planes=planes_host, manh=manh_host,
        )
        out.append((res, feed))
    return out


def run_fused_step(
    cfg: VOConfig,
    gray_u8: torch.Tensor,  # (S, H, W) uint8
    depth_mm: torch.Tensor,  # (S, h, w) int32
    args,  # S StepArgs
    radius: float = 15.0,
    check_octave: bool = True,
):
    """One fused step for S sequences, pulled to the host with ONE
    synchronization and split per sequence: launch, then collect. Returns,
    per sequence, (StepResult, LineFeed of this frame on the device or
    None)."""
    return collect_fused_step(
        launch_fused_step(cfg, gray_u8, depth_mm, args, radius=radius, check_octave=check_octave)
    )


def _host_seg(planes, centroids, counts, valid, covs) -> plane_ops.PlaneSegmentation:
    """A host segmentation without its per-block maps (empty)."""
    return plane_ops.PlaneSegmentation(
        planes, centroids, counts, valid, np.zeros((0, 0), np.int32),
        np.zeros((0, 0, 3), np.float32), covs,
    )


def _host_plane_step(planes, centroids, counts, valid, covs, map_idx, kind, inlier) -> PlaneStep:
    """Host PlaneStep in the JAX package's dtypes (int32 rows and kinds)."""
    return PlaneStep(_host_seg(planes, centroids, counts, valid, covs),
                     map_idx.astype(np.int32), kind.astype(np.int32), inlier)


def _pose_delta(T_new: np.ndarray, T_primary: np.ndarray) -> float:
    """Translation plus 4 m/rad times rotation between a recovered pose and
    the failed primary estimate (hfvo_tpu/tracking/tracker.py:944-967):
    0.01 rad already moves an edge pixel ~7 px at fx = 535. A singular or
    non-finite primary counts as infinitely far."""
    if not np.isfinite(T_primary).all():
        return np.inf
    try:
        d = np.asarray(T_new, np.float64) @ np.linalg.inv(T_primary)
    except np.linalg.LinAlgError:
        return np.inf
    if not np.isfinite(d).all():
        return np.inf
    rot = np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.linalg.norm(d[:3, 3]) + 4.0 * np.arccos(rot))


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
    device: torch.device = "cuda"
    use_local_ba: bool = True
    use_loop_closing: bool = True
    # In-flight frame budget of track_rgbd_async. 1 = one-frame lag
    # (dispatch this frame, then resolve the previous one); >= 2 resolves
    # frame i - depth BEFORE dispatching frame i, so its result has been on
    # the host for (depth - 1) calls. Map updates lag `depth` frames.
    pipeline_depth: int = 1
    # Frames resolved together once that many in-flight frames accumulate
    # (the JAX package pulls such a group with one transfer); 0 = max(1,
    # pipeline_depth // 2). It decides which call returns which frames.
    resolve_burst: int = 0
    vomap: VOMap = field(init=False)
    mapper: LocalMapper = field(init=False)
    state: TrackState = TrackState.NOT_INITIALIZED
    T_cw: np.ndarray = field(init=False)
    velocity: np.ndarray = field(init=False)  # T_cw_cur @ inv(T_cw_last)
    frame_id: int = -1
    last_kf_frame: int = -1
    n_matches_ref_kf: int = 0
    # Early-loss auto-reset (reference: Tracking.cc:918-926). Tests that
    # exercise relocalization against an infant map turn it off.
    auto_reset: bool = True

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.vomap = VOMap(self.cfg)
        self.mapper = LocalMapper(self.cfg, self.vomap, self.device)
        self.loop_closer = LoopCloser(self.cfg, self.vomap, self.device)
        self.T_cw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self._snap = None
        self._snap_pad = None
        self._last_words = None  # (frame_id, word ids) from the fused step
        # (LineFeatures, Lines3D, map line id per segment) of the last step
        # or initialization, host numpy; consumed by keyframe insertion.
        self._last_line_out = None
        # Previous frame's segments for the frame-to-frame and flow channel:
        # {"fid", "gid" (host global map-line id per segment), "dev" (LineFeed)}.
        self._prev_line_feed = None
        # (PlaneSegmentation, map-plane row, kind, inlier) of the last step
        # or initialization, host numpy; consumed by keyframe insertion and
        # the coarse Manhattan init's plane seed.
        self._last_plane_out = None
        self._last_axes = None  # (measured axes (3, 3), supports (3,)) of the last step
        self._snap_planes = None  # device (mp_pi, mp_valid) of the snapshot
        self._last_n_matches = 0
        self.last_reloc = None  # (branch "3d3d" or "pnp", candidate slot) of the last relocalization
        # World Manhattan rotation (columns = axes) once initialized
        # (reference: Map::SetWorldManhAxis, src/Map.cc:144).
        self.R_wm = np.eye(3, dtype=np.float32)
        self.manh_valid = False
        self._manh_fine_done = False
        # The fine init's result, computed at one keyframe and applied at the
        # next (the JAX package dispatches it at one and pulls it at the next).
        self._manh_fine_pending = None
        # Per-stage accumulated wall times (reference: System::ExtractTimes,
        # src/System.cc:406-425): name -> [seconds, count].
        self.stage_times: dict = {}
        self.kf_db = KeyFrameDatabase(self.cfg.cap.keyframes)
        self.mapper._kf_db = self.kf_db
        # Per-frame (ref_kf_slot, T_cr) for keyframe-relative trajectory
        # chaining (reference: System::SaveTrajectoryTUM, src/System.cc:346).
        self._traj_rel: list = []
        self._pipe: list = []  # in-flight frames of track_rgbd_async, oldest first
        self._groups: list = []  # groups of in-flight frames resolved together
        self._used_fallback = False
        self._fallback_delta = np.inf
        # Live-viewer hook (viz.live.LiveViewer): finish_step keeps the
        # frame's keypoints when it is on.
        self.viz_enabled = False
        self._last_viz_kp = None
        # Static feature mask on the device (uploaded once; reference loads
        # ./masks/mask.png at startup, src/Tracking.cc:82-86).
        self._mask_dev = None
        if self.cfg.tracking.static_mask_path:
            m = read_mask(self.cfg.tracking.static_mask_path,
                          self.cfg.camera.height, self.cfg.camera.width)
            self._mask_dev = self._upload(m)

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
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:  # decoded or received frames are read-only views
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

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
            self._initialize(feats, gray_f, depth_f, T_cw_init)
            self._record_trajectory()
            return TrackResult(self.state, self.T_cw.copy(), 0, True)
        gray_u8 = self._upload(_gray_u8(gray_np)[None])
        depth_mm = self._upload(self._depth_host_u16(depth_np).astype(np.int32)[None])
        return self._track_prepared(gray_u8, depth_mm)

    # ---- pipelined tracking (hfvo_tpu/tracking/tracker.py:1054-1280) ----

    def track_rgbd_async(self, gray: np.ndarray, depth: np.ndarray,
                         T_cw_init: Optional[np.ndarray] = None) -> list:
        """Pipelined tracking: dispatch this frame's fused step against a
        constant-velocity prediction chained on the in-flight poses
        (T_prev inv(T_pp) T_prev, on the device), and resolve older frames,
        so that host bookkeeping overlaps the device's work.

        At pipeline_depth 1 the frame is dispatched, then the previous one
        resolved; at depth >= 2 the frame `depth` calls old is resolved
        first. Returns the TrackResults that became final during this call
        (none on the first `depth` calls); call `flush()` at the end.
        Keyframes and map updates lag `depth` frames: a dispatched frame
        tracks against the map snapshot of its dispatch. While not OK, the
        pipe is flushed and the frame tracked synchronously."""
        if self.state is not TrackState.OK:
            out = self.flush()
            out.append(self.track_rgbd(gray, depth, T_cw_init))
            return out
        tm = self.step_times = getattr(self, "step_times", {"upload": [], "dispatch": [], "resolve": []})
        for v in tm.values():
            if len(v) >= 512:
                del v[: len(v) - 511]
        results: list = []
        if self.pipeline_depth > 1:
            # Resolve first: the oldest in-flight frame keeps the velocity
            # baseline exactly one frame behind the newest in-flight pose.
            t0 = time.perf_counter()
            while self._pipe and len(self._pipe) >= self.pipeline_depth:
                results.extend(self._resolve_burst())
            tm["resolve"].append(time.perf_counter() - t0)
            if self.state is not TrackState.OK:
                results.append(self.track_rgbd(gray, depth, T_cw_init))
                return results

        self.frame_id += 1
        t0 = time.perf_counter()
        gray_u8 = self._upload(_gray_u8(np.asarray(gray))[None])
        depth_mm = self._upload(self._depth_host_u16(np.asarray(depth)).astype(np.int32)[None])
        tm["upload"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        if not self._pipe:
            T_pred = (self.velocity @ self.T_cw).astype(np.float32)
        else:
            # The newest pending pose is still in flight: chain on it on the
            # device. The baseline is the second-newest in-flight pose (the
            # last resolved one while only one is in flight), inverted as a
            # matrix, as the synchronous velocity is: the rigid inverse
            # (transpose) would triple the LM outputs' float32
            # non-orthogonality at every chained frame.
            T_a = self._pipe[-1]["step"].T_cw[0]
            if len(self._pipe) >= 2:
                T_b = torch.linalg.inv(self._pipe[-2]["step"].T_cw[0])
            else:
                T_b = self._upload(np.linalg.inv(self.T_cw).astype(np.float32))
            T_pred = T_a @ T_b @ T_a
        args = self.prepare_step(T_pred)
        step = launch_fused_step(self.cfg, gray_u8, depth_mm, [args])
        self._pipe.append(dict(step=step, fid=self.frame_id, gray=gray_u8, depth=depth_mm))
        self._group_pending()
        tm["dispatch"].append(time.perf_counter() - t0)
        if self.pipeline_depth == 1:
            # Dispatch, then resolve: this dispatch overlaps the previous
            # frame's device work.
            t0 = time.perf_counter()
            while len(self._pipe) > 1:
                results.extend(self._resolve_oldest())
            tm["resolve"].append(time.perf_counter() - t0)
        return results

    def flush(self) -> list:
        """Resolve every in-flight frame of track_rgbd_async; returns their
        TrackResults (a tail of 2 or more ungrouped frames resolves as one
        group)."""
        if self._pipe and self._burst_k() > 1:
            n = sum(len(g) for g in self._groups)
            if len(self._pipe) - n >= 2:
                self._groups.append(self._pipe[n:])
        results: list = []
        while self._pipe:
            results.extend(self._resolve_burst())
        return results

    def _burst_k(self) -> int:
        return self.resolve_burst if self.resolve_burst > 0 else max(1, self.pipeline_depth // 2)

    def _group_pending(self) -> None:
        """Once K dispatched but ungrouped frames accumulate, they form a
        group, resolved together when its head reaches the pipe's head."""
        k = self._burst_k()
        if k <= 1:
            return
        n = sum(len(g) for g in self._groups)
        while len(self._pipe) - n >= k:
            self._groups.append(self._pipe[n:n + k])
            n += k

    def _resolve_burst(self) -> list:
        """Resolve the oldest group, or the oldest frame when no group
        starts at the pipe's head."""
        results: list = []
        if self._groups and self._pipe and self._groups[0][0] is self._pipe[0]:
            for p in self._groups.pop(0):
                # A failure inside the group re-tracked every in-flight frame
                # synchronously and emptied the pipe: the groups are stale.
                if not self._pipe or self._pipe[0] is not p:
                    self._groups.clear()
                    break
                results.extend(self._resolve_oldest())
            return results
        results.extend(self._resolve_oldest())
        if not self._pipe:
            self._groups.clear()
        return results

    def _resolve_oldest(self) -> list:
        """Collect the oldest in-flight frame and run its host path. A frame
        that ends not OK, or that needed a fallback other than a wide-window
        recovery within 0.02 of its primary pose, poisons its successors'
        chained predictions: they are re-tracked synchronously, in order."""
        p = self._pipe.pop(0)
        saved_fid = self.frame_id
        self.frame_id = p["fid"]
        try:
            ((out, feed_dev),) = collect_fused_step(p["step"])
            (args,) = p["step"].args
            five = self.finish_step(out, args.pad, args.lpad, feed_dev)
            res = self._post_track(five, p["gray"], p["depth"])
        finally:
            self.frame_id = saved_fid
        results = [res]
        benign = self._used_fallback and self._fallback_delta < 0.02
        if res.state is not TrackState.OK or (self._used_fallback and not benign):
            dead, self._pipe = self._pipe, []
            for d in dead:
                saved_fid = self.frame_id
                self.frame_id = d["fid"]
                try:
                    results.append(self._track_prepared(d["gray"], d["depth"]))
                finally:
                    self.frame_id = saved_fid
        return results

    def _track_prepared(self, gray, depth) -> TrackResult:
        """Track one uploaded frame: gray (1, H, W) uint8, depth (1, h, w)
        int32 millimetres. While LOST, relocalize by appearance first
        (reference: Tracking::Relocalization, src/Tracking.cc:3760)."""
        T_pred = self.velocity @ self.T_cw
        if self.state is TrackState.LOST:
            t0 = time.perf_counter()
            T_reloc = self._relocalize(gray, depth)
            self._stage("relocalize", time.perf_counter() - t0)
            if T_reloc is not None:
                T_pred = T_reloc
                self.velocity = np.eye(4, dtype=np.float32)
        return self._post_track(self._track_local_map(gray, depth, T_pred), gray, depth)

    def _post_track(self, five, gray, depth) -> TrackResult:
        """Everything after the primary step: the wide-window retry,
        pose/velocity update, keyframe policy, mapping, trajectory."""
        ok, T_new, pt_per_kp, n_matches, feats = five
        self._used_fallback = False
        # How far a wide-window recovery landed from the failed primary
        # estimate (inf for any other fallback): in-flight successors of
        # track_rgbd_async chained their predictions on the primary pose.
        self._fallback_delta = np.inf
        T_primary = np.asarray(T_new, np.float64)
        if not ok:
            # Wide-window recovery from the last pose (reference falls back
            # from the motion model to wider searches the same way).
            self._used_fallback = True
            ok, T_new, pt_per_kp, n_matches, feats = self._track_local_map(
                gray, depth, self.T_cw, radius=50.0, check_octave=False
            )
            if ok:
                self._fallback_delta = _pose_delta(T_new, T_primary)
        if not ok:
            # Window-free fallback vs the reference keyframe (reference:
            # TrackReferenceKeyFrame, src/Tracking.cc:1831). Descriptor-only
            # matches can produce a false consensus, so acceptance demands a
            # much larger inlier count than the normal gate.
            T_ref = self._track_reference_kf(feats)
            if T_ref is not None:
                ok, T_new, pt_per_kp, n_matches, feats = self._track_local_map(gray, depth, T_ref)
                ok = ok and n_matches >= 3 * self.cfg.tracking.min_matches_track
        is_kf = False
        if ok:
            vel = T_new @ np.linalg.inv(self.T_cw)
            self.velocity = vel.astype(np.float32)
            self.T_cw = T_new.astype(np.float32)
            self.state = TrackState.OK
            if self._need_new_keyframe(n_matches, feats, pt_per_kp):
                if self.cfg.use_manhattan and not self.manh_valid:
                    self._try_coarse_manhattan(depth)
                t0 = time.perf_counter()
                self._create_keyframe(feats, pt_per_kp)
                self._stage("kf_insert", time.perf_counter() - t0)
                # The ratio rule compares against the reference KF's tracked
                # matches (src/Tracking.cc:2966-2985).
                self.n_matches_ref_kf = max(n_matches, 1)
                is_kf = True
                # Epipolar triangulation reaches keypoints depth could not
                # landmark (reference order: CreateNewMapPoints runs before
                # fuse + BA, src/LocalMapping.cc:82-122).
                if self.cfg.tracking.triangulate_new_points:
                    t0 = time.perf_counter()
                    self.mapper.create_new_map_points()
                    self._stage("kf_triangulate", time.perf_counter() - t0)
                if self.cfg.use_lines and self.cfg.tracking.triangulate_new_lines:
                    t0 = time.perf_counter()
                    self.mapper.create_new_map_lines()
                    self._stage("kf_triangulate_lines", time.perf_counter() - t0)
                t0 = time.perf_counter()
                self.mapper.fuse_points()
                if self.cfg.use_lines:
                    self.mapper.fuse_lines()
                self.mapper.reelect_point_descriptors()
                self._stage("kf_fuse", time.perf_counter() - t0)
                self._local_ba()
                t0 = time.perf_counter()
                if self.use_loop_closing and self.loop_closer.detect_and_close(self):
                    self.T_cw = self.vomap.keyframes.T_cw[self.vomap.newest_kf_slot].copy()
                self._stage("loop_detect", time.perf_counter() - t0)
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
            if self.auto_reset and self.vomap.n_keyframes() <= 5:
                self.reset()
        self._record_trajectory()
        return TrackResult(self.state, self.T_cw.copy(), n_matches, is_kf)

    # ------------------------------------------------------------------

    def _local_ba(self) -> None:
        """Local BA over the keyframe window when it is on; BA may have moved
        the newest keyframe, which is this frame's pose."""
        if not self.use_local_ba:
            return
        t0 = time.perf_counter()
        self.mapper.run_local_ba()
        self._stage("local_ba", time.perf_counter() - t0)
        self.T_cw = self.vomap.keyframes.T_cw[self.vomap.newest_kf_slot].copy()

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

    def _initialize(
        self,
        feats: FrameFeatures,
        gray: torch.Tensor,
        depth: torch.Tensor,
        T_cw_init: Optional[np.ndarray],
    ):
        """Create the first keyframe + map points and lines from depth
        (reference: StereoInitialization, src/Tracking.cc:1350). `gray` and
        `depth` are the float32 device images of the frame."""
        if T_cw_init is not None:
            self.T_cw = T_cw_init.astype(np.float32)
        valid = feats.valid & (feats.depth > 1e-3)
        if valid.sum() < 50:
            return  # not enough depth to initialize
        if self.cfg.use_lines:
            t0 = time.perf_counter()
            lf = line_ops.detect_lines(gray, capacity=self.cfg.cap.lines)
            l3d = lines3d.fit_lines_3d(
                depth, self.cfg.camera, lf.p0, lf.p1, lf.valid,
                min_valid=self.cfg.lines.min_valid_depth_samples,
                min_length=self.cfg.lines.min_length_3d,
            )
            host = to_host([*lf, *l3d])
            none = np.full((self.cfg.cap.lines,), -1, np.int32)
            self._last_line_out = (
                line_ops.LineFeatures(*host[:6]), lines3d.Lines3D(*host[6:]), none
            )
            # Line feed so frame 1 can already run the f2f / flow channel.
            self._prev_line_feed = dict(
                fid=self.frame_id, gid=none.copy(),
                dev=LineFeed(lf.p0, lf.p1, lf.desc, lf.valid,
                             torch.clamp(gray, 0, 255).to(torch.uint8)),
            )
            self._stage("init_lines", time.perf_counter() - t0)
        if self.cfg.use_planes:
            seg = plane_ops.segment_planes(depth, self.cfg.camera, max_planes=self.cfg.cap.planes)
            host = to_host([seg.planes, seg.centroids, seg.counts, seg.valid, seg.covs])
            none = np.full((self.cfg.cap.planes,), -1, np.int32)
            self._last_plane_out = PlaneStep(_host_seg(*host), none, none.copy(), np.zeros_like(none, bool))
        if self.cfg.use_manhattan:
            self._try_coarse_manhattan(depth)
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
        self._snap_planes = None

    def _local_line_snapshot(self):
        """(LineSnapshot, lpad): the local map lines on the device, and the
        global line id of each row (-1 = empty row), at most
        `cap.local_lines` rows; empty rows past the last local line are
        left out, as for points."""
        ids = self.vomap.local_line_ids(self.cfg.tracking.local_map_size_kf,
                                        self.cfg.cap.local_lines)
        lpad = np.full((max(len(ids), 1),), -1, np.int64)
        lpad[: len(ids)] = ids
        safe = np.maximum(lpad, 0)
        t = self.vomap.lines
        host = (t.X0_w[safe], t.X1_w[safe], t.desc[safe], (lpad >= 0) & t.valid[safe])
        return LineSnapshot(*(self._upload(a) for a in host)), lpad

    def _local_map_snapshot(self):
        """Device-resident local-map snapshot, rebuilt only when the map
        changed (keyframe insertion / culling). Returns (tensors, pad) where
        `pad` maps snapshot rows to global point ids (-1 = empty row); it
        holds at most `cap.local_points` rows. With lines, `tensors` ends
        with (LineSnapshot, lpad), lpad mapping rows to global line ids."""
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
        if self.cfg.use_lines:
            self._snap = self._snap + self._local_line_snapshot()
        if self.cfg.use_planes:
            # The plane table is small: all its slots, as they are now (the
            # per-frame coefficient refits reach the step at the next
            # snapshot).
            mp = self.vomap.planes
            self._snap_planes = (self._upload(mp.pi_w.copy()), self._upload(mp.valid.copy()))
        self._snap_pad = pad
        self._stage("kf_snapshot", time.perf_counter() - t0)
        return self._snap, pad

    def prepare_step(self, T_pred: np.ndarray) -> StepArgs:
        """This tracker's inputs of the fused step besides its images (split
        out so that a batch runner can stack several trackers' inputs into
        one step): the local-map snapshot, the predicted pose and, with
        lines, the line snapshot, the previous frame's line feed and its
        rows in the snapshot, and the previous pose; with planes, the map
        planes; with Manhattan axes, the world axes and their validity; with
        a mask file, the static mask. `T_pred` is a host pose or an
        in-flight device pose (track_rgbd_async)."""
        snap, pad = self._local_map_snapshot()
        if isinstance(T_pred, torch.Tensor):
            T_pred_d = T_pred  # an in-flight prediction, already on the device
        else:
            T_pred_d = self._upload(np.asarray(T_pred, np.float32))
        kw = {}
        if self.cfg.use_lines:
            *snap, line_snap, lpad = snap
            feed, prev_row = self._prev_feed(lpad)
            kw.update(line_snap=line_snap, feed=feed, prev_row=prev_row, lpad=lpad,
                      T_prev=self._upload(np.asarray(self.T_cw, np.float32)))
        if self.cfg.use_planes:
            kw.update(planes=self._snap_planes)
        if self.cfg.use_manhattan:
            kw.update(manh=(self._upload(np.asarray(self.R_wm, np.float32)),
                            torch.tensor(bool(self.manh_valid), device=self.device)))
        return StepArgs(tuple(snap), T_pred_d, pad, mask=self._mask_dev, **kw)

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
        src/Tracking.cc:2251, :2816) — one fused step at S = 1, one host
        sync."""
        t0 = time.perf_counter()
        args = self.prepare_step(T_pred)
        ((out, feed_dev),) = run_fused_step(
            self.cfg, gray, depth, [args], radius=radius, check_octave=check_octave
        )
        self._stage("fused_step", time.perf_counter() - t0)
        return self.finish_step(out, args.pad, args.lpad, feed_dev)

    def _prev_feed(self, lpad: np.ndarray):
        """(LineFeed, prev_row (Ml,) device int64): the previous frame's
        segments, with their global map-line ids remapped into the current
        snapshot's rows (the snapshot may have been rebuilt since the feed
        was captured). A tracker with no previous frame (restored from a
        checkpoint) gets an empty feed, as the JAX package's does
        (hfvo_tpu/tracking/tracker.py:1563-1572)."""
        feed = self._prev_line_feed
        if feed is None:
            Ml = self.cfg.cap.lines
            H, W = self.cfg.camera.height, self.cfg.camera.width
            z = lambda *shape: torch.zeros(shape, device=self.device)  # noqa: E731
            empty = LineFeed(z(Ml, 2), z(Ml, 2), z(Ml, line_ops.DESC_BANDS * 4),
                             torch.zeros(Ml, dtype=torch.bool, device=self.device),
                             torch.zeros((H, W), dtype=torch.uint8, device=self.device))
            return empty, torch.full((Ml,), -1, dtype=torch.int64, device=self.device)
        inv = np.full((self.cfg.cap.map_lines,), -1, np.int64)
        rows = np.nonzero(lpad >= 0)[0]
        inv[lpad[rows]] = rows
        gid = feed["gid"]
        prev_row = np.where(gid >= 0, inv[np.maximum(gid, 0)], -1)
        return feed["dev"], self._upload(prev_row.astype(np.int64))

    def finish_step(self, out: StepResult, pad: np.ndarray, lpad=None, feed_dev=None):
        """Host bookkeeping for one pulled step result; returns
        (ok, T_cw, pt_per_kp, n_inliers, feats). With lines, `lpad` maps
        line snapshot rows to global ids and `feed_dev` (this frame's
        segments and uint8 image, on the device) becomes the next frame's
        line feed."""
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

        self._last_line_out = None
        if out.lines is not None:
            self._finish_lines(out.lines, lpad, feed_dev)
        self._last_plane_out = None
        if out.planes is not None:
            self._finish_planes(out.planes, out.T_cw)
        self._last_axes = out.manh

        ok = n_in >= self.cfg.tracking.min_matches_track and np.isfinite(T_new).all()
        # A sudden match collapse (>75% drop vs the previous frame) means the
        # solution jumped basins even if the absolute count clears the gate.
        if ok and self._last_n_matches > 0 and n_in < 0.25 * self._last_n_matches:
            ok = False
        if ok:
            self._last_n_matches = n_in
        if self.viz_enabled:
            # Reference swap for the live viewer's frame overlay (reference:
            # FrameDrawer::Update, src/FrameDrawer.cc:247).
            self._last_viz_kp = (out.feats.uv, pt_per_kp >= 0, out.feats.valid)
        return ok, T_new.astype(np.float32), pt_per_kp, n_in, out.feats

    def _finish_lines(self, ls: LineStep, lpad: np.ndarray, feed_dev: LineFeed) -> None:
        """Line bookkeeping of one step (hfvo_tpu/tracking/tracker.py:
        1658-1695): map-line visible/found counters, the inlier map line per
        segment, and this frame's segments as the next line feed."""
        lines = self.vomap.lines
        ln_per_seg = np.where(ls.ln_local >= 0, lpad[np.maximum(ls.ln_local, 0)], -1)
        lmatched = ln_per_seg >= 0
        lines.n_visible[lpad[ls.visible & (lpad >= 0)]] += 1
        lfound = ln_per_seg[lmatched & ls.ln_inlier]
        lines.n_found[lfound] += 1
        lines.last_seen_frame[lfound] = self.frame_id
        ln_per_seg = np.where(lmatched & ls.ln_inlier, ln_per_seg, -1).astype(np.int32)
        # A recovered line keeps its map line alive although no detected
        # segment matched it (src/Tracking.cc:2299-2309).
        rec_g = np.where((ls.rec_rows >= 0) & ls.rec_inlier, lpad[np.maximum(ls.rec_rows, 0)], -1)
        rec_found = rec_g[rec_g >= 0]
        lines.n_found[rec_found] += 1
        lines.n_visible[rec_found] += 1
        lines.last_seen_frame[rec_found] = self.frame_id
        self._last_line_out = (ls.lf, ls.l3d, ln_per_seg)
        self._prev_line_feed = dict(fid=self.frame_id, gid=ln_per_seg.copy(), dev=feed_dev)

    def _finish_planes(self, ps: PlaneStep, T_new: np.ndarray) -> None:
        """Plane bookkeeping of one step (hfvo_tpu/tracking/tracker.py:
        1697-1720): last-seen frames of fully matched map planes, and a
        coefficient refit of each from the observation's moments (reference:
        UpdateCoefficientsAndPoints, src/Tracking.cc:795-800)."""
        seg, p_map_idx, p_kind, p_inlier = ps
        self.vomap.planes.last_seen_frame[p_map_idx[(p_kind == 0) & p_inlier]] = self.frame_id
        self._last_plane_out = ps
        upd = seg.valid & (p_kind == 0) & p_inlier & (p_map_idx >= 0)
        if upd.any() and np.isfinite(T_new).all():
            T_wc = np.linalg.inv(T_new)
            R, tw = T_wc[:3, :3], T_wc[:3, 3]
            self.vomap.update_plane_coefficients(
                p_map_idx[upd],
                (seg.centroids[upd] @ R.T + tw).astype(np.float64),
                np.einsum("ab,nbc,dc->nad", R, seg.covs[upd], R),
                seg.counts[upd],
            )

    def _full_depth(self, depth: torch.Tensor) -> torch.Tensor:
        """A tracked frame's depth upload ((1, h, w) int32 millimetres,
        possibly subsampled) as (H, W) float metres at full resolution;
        float depth passes through."""
        if depth.dim() == 3:
            depth = depth[0]
        if depth.dtype.is_floating_point:
            return depth
        H, W = self.cfg.camera.height, self.cfg.camera.width
        d = depth.float() * 1e-3
        if d.shape[0] != H:
            s = -(-H // d.shape[0])
            d = d.repeat_interleave(s, dim=0).repeat_interleave(s, dim=1)[:H, :W]
        return d

    def _match_keyframe(self, desc: torch.Tensor, valid: torch.Tensor, k: int):
        """Mutual descriptor matches of a frame's keypoints (device desc
        (N, 8) int64, valid (N,)) against keyframe slot k's observations:
        (map point id per keypoint, matched to a valid map point), host."""
        kf = self.vomap.keyframes
        idx_b, mok = to_host(list(matcher.match_descriptors_mutual(
            desc, valid, self._upload(kf.desc[k].astype(np.int64)), self._upload(kf.obs_valid[k]))))
        pid = kf.point_id[k][idx_b]
        return pid, mok & (pid >= 0) & self.vomap.points.valid[np.maximum(pid, 0)]

    def _track_reference_kf(self, feats: FrameFeatures):
        """Window-free descriptor matching against the newest keyframe,
        solved by 3D-3D RANSAC (hfvo_tpu/tracking/tracker.py:1742-1777;
        reference: TrackReferenceKeyFrame, src/Tracking.cc:1831). `feats`
        holds host arrays. Returns a pose estimate or None."""
        k = self.vomap.newest_kf_slot
        if k < 0:
            return None
        pid, matched = self._match_keyframe(
            self._upload(feats.desc.astype(np.int64)), self._upload(feats.valid), k)
        good = matched & (feats.depth > 1e-3)
        if good.sum() < 15:
            return None
        X_c = camera.unproject(self.cfg.camera, self._upload(feats.uv),
                               self._upload(np.maximum(feats.depth, 1e-3)))
        res = ransac_rigid_3d3d(self._upload(self.vomap.points.X_w[np.maximum(pid, 0)]), X_c,
                                self._upload(good), self.frame_id)
        T_ab, ok = to_host([res.T_ab, res.ok])
        return np.linalg.inv(T_ab).astype(np.float32) if bool(ok) else None

    def _relocalize(self, gray: torch.Tensor, depth: torch.Tensor):
        """BoW candidate retrieval and pose recovery (hfvo_tpu/tracking/
        tracker.py:1779-1841; reference: Tracking::Relocalization,
        src/Tracking.cc:3760): the frame's words and histogram against the
        keyframe database's top 5, then per candidate the mutual matches,
        3D-3D RANSAC on the keypoints with depth and, failing that, the
        depth-free 2D-3D PnP RANSAC with the candidate's pose in its pool
        (the reference's EPnP path, src/Tracking.cc:3805). `gray` (1, H, W)
        uint8 and `depth` (1, h, w) int32 millimetres are the tracked
        frame's uploads. Returns T_cw or None; the local-map track that
        follows refines it."""
        self.last_reloc = None
        feats = extract_frame(gray[0].float(), self._full_depth(depth), self.cfg)
        words = compute_words(feats.desc)
        hist = to_host([bow_histogram(words, feats.valid)])[0]
        cands, _ = self.kf_db.query(hist, top_k=5)
        if len(cands) == 0:
            return None
        X_c = camera.unproject(self.cfg.camera, feats.uv, torch.clamp(feats.depth, min=1e-3))
        depth_h = to_host([feats.depth])[0]
        kf = self.vomap.keyframes
        for k in cands:
            pid, matched = self._match_keyframe(feats.desc, feats.valid, int(k))
            good = matched & (depth_h > 1e-3)
            Xa = self._upload(self.vomap.points.X_w[np.maximum(pid, 0)])
            if good.sum() >= 15:
                res = ransac_rigid_3d3d(Xa, X_c, self._upload(good), self.frame_id)
                T_ab, ok = to_host([res.T_ab, res.ok])
                if bool(ok):
                    self.last_reloc = ("3d3d", int(k))
                    return np.linalg.inv(T_ab).astype(np.float32)
            if matched.sum() >= 15:
                res = pnp_ransac(Xa, feats.uv, self._upload(matched), self.cfg.camera, self.frame_id,
                                 T_init=self._upload(kf.T_cw[k]))
                T_cw, ok = to_host([res.T_cw, res.ok])
                if bool(ok):
                    self.last_reloc = ("pnp", int(k))
                    return T_cw.astype(np.float32)
        return None

    def _try_coarse_manhattan(self, depth: torch.Tensor) -> None:
        """One-shot world Manhattan axes from the frame's normals, line
        directions and vanishing points (hfvo_tpu/tracking/tracker.py:
        1843-1922; reference: Tracking::ExtractCoarseManhAx,
        src/Tracking.cc:533-585, retried until it succeeds)."""
        cam = self.cfg.camera
        normals, ok = plane_ops.compute_normals(self._full_depth(depth), cam, stride=8)
        normals, ok = to_host([normals, ok])
        d = normals[ok]
        line_dirs_np = None
        if self._last_line_out is not None:
            lf, l3d, _ = self._last_line_out
            v3 = np.asarray(l3d.valid)
            if v3.any():
                ld = np.asarray(l3d.X1_c)[v3] - np.asarray(l3d.X0_c)[v3]
                ld /= np.linalg.norm(ld, axis=1, keepdims=True) + 1e-9
                line_dirs_np = ld
                d = np.concatenate([d, ld.astype(d.dtype)])
            # Vanishing points add depth-free structure, each repeated to
            # carry weight (reference: Frame.cc:330-337).
            vpr = vp_ops.estimate_vps(cam, *(self._upload(np.asarray(a)) for a in (lf.p0, lf.p1, lf.valid)))
            vps, sup, vp_ok = to_host([vpr.vps, vpr.support, vpr.ok])
            if bool(vp_ok):
                reps = np.repeat(vps, np.clip(sup, 0, 20), axis=0)
                if len(reps):
                    d = np.concatenate([d, reps.astype(d.dtype)])
        if len(d) < 100:
            return
        sub = d[:: max(len(d) // 1500, 1)].astype(np.float32)
        CAP = 1536  # the JAX package's fixed size, which fixes the random pairs
        n = min(len(sub), CAP)
        w = np.zeros((CAP,), np.float32)
        w[:n] = 1.0
        buf = np.zeros((CAP, 3), np.float32)
        buf[:n] = sub[:CAP]
        rng = np.random.RandomState(self.frame_id + 1)
        pairs = buf[rng.randint(0, max(n, 1), size=(24, 2))]
        # A perpendicular plane pair (else plane + line) seeds the first
        # hypothesis (reference: Map::FindManhattan, src/Map.cc:150-394).
        if self._last_plane_out is not None:
            seg = self._last_plane_out.seg
            seed = manh_ops.plane_seed_pair(
                seg.planes[:, :3], seg.counts, seg.valid, line_dirs=line_dirs_np,
                ver_th=self.cfg.planes.vertical_threshold,
            )
            if seed is not None:
                pairs[0] = seed
        R_cm, rate = manh_ops.coarse_manhattan_init(
            self._upload(buf), self._upload(w), self._upload(pairs), cone=self.cfg.manhattan.normal_cone,
        )
        R_cm, rate = to_host([R_cm, rate])
        if float(rate) > self.cfg.manhattan.coarse_success_rate:
            R_wc = np.linalg.inv(self.T_cw)[:3, :3]
            self._set_manhattan((R_wc @ R_cm).astype(np.float32))

    def _set_manhattan(self, R_wm: np.ndarray) -> None:
        self.R_wm = R_wm
        self.manh_valid = True
        self.mapper.R_wm = R_wm
        self.mapper.manh_valid = True

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
        axes_c = axes_sup = None
        if self._last_axes is not None:
            axes_c = np.asarray(self._last_axes[0], np.float32)
            axes_sup = np.asarray(self._last_axes[1], np.int32)
        kf_slot = self.vomap.add_keyframe(
            self.T_cw, self.frame_id, pt_per_kp.astype(np.int32),
            feats.obs, feats.octave, feats.desc, obs_valid,
            axes_c=axes_c, axes_sup=axes_sup, kp_valid=valid,
        )
        # Appearance index (reference: KeyFrameDatabase::add). Words arrive
        # with the fused step; the init path computes them here.
        if self._last_words is not None and self._last_words[0] == self.frame_id:
            words = self._last_words[1]
        else:
            desc = self._upload(feats.desc.astype(np.int64))
            words = to_host([compute_words(desc)])[0]
        self.kf_db.add(kf_slot, bow_histogram_np(words, valid))
        if self.cfg.use_lines and self._last_line_out is not None:
            t0 = time.perf_counter()
            self._add_keyframe_lines(kf_slot)
            self._stage("kf_lines_add", time.perf_counter() - t0)
        if self.cfg.use_manhattan:
            t0 = time.perf_counter()
            self._fine_manhattan()
            self._stage("kf_manh_fine", time.perf_counter() - t0)
        if self.cfg.use_planes and self._last_plane_out is not None:
            t0 = time.perf_counter()
            self._add_keyframe_planes(kf_slot)
            self._stage("kf_planes_add", time.perf_counter() - t0)
        self.last_kf_frame = self.frame_id
        self.n_matches_ref_kf = int(obs_valid.sum())
        self.vomap.cull_points(self.frame_id)

    def _add_keyframe_lines(self, kf_slot: int) -> None:
        """The line part of keyframe insertion (hfvo_tpu/tracking/
        tracker.py:2024-2081): unmatched segments with a 3D fit become new
        map lines, tagged with their Manhattan axis once the frame exists,
        and the keyframe stores its line observations."""
        lf, l3d, ln_per_seg = self._last_line_out
        lvalid = lf.valid
        p0, p1 = lf.p0, lf.p1
        d = p1 - p0
        n = np.stack([-d[:, 1], d[:, 0]], axis=1)
        n = n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-9)
        line2d = np.concatenate([n, -np.sum(n * p0, axis=1, keepdims=True)], axis=1).astype(np.float32)
        ln_per_seg = np.asarray(ln_per_seg).copy()
        lidx = np.nonzero(lvalid & l3d.valid & (ln_per_seg < 0))[0]
        if len(lidx):
            T_wc = np.linalg.inv(self.T_cw)
            X0w = (T_wc[:3, :3] @ l3d.X0_c[lidx].T).T + T_wc[:3, 3]
            X1w = (T_wc[:3, :3] @ l3d.X1_c[lidx].T).T + T_wc[:3, 3]
            lids = self.vomap.add_lines(
                X0w.astype(np.float32), X1w.astype(np.float32), lf.desc[lidx],
                self.frame_id, first_kf=kf_slot,
            )
            created = lids >= 0
            ln_per_seg[lidx[created]] = lids[created]
            if self.manh_valid and created.any():
                # Tag new lines with their Manhattan axis (reference:
                # Manhattan::LineManhAxisCorresp, src/Manhattan.cpp:1139).
                dw = X1w[created] - X0w[created]
                dw /= np.linalg.norm(dw, axis=1, keepdims=True) + 1e-9
                cosang = np.abs(dw @ self.R_wm)
                ok_ax = cosang.max(axis=1) > np.cos(self.cfg.manhattan.line_cone)
                self.vomap.lines.manh_idx[lids[created]] = np.where(
                    ok_ax, cosang.argmax(axis=1), -1).astype(np.int32)
        self.vomap.add_kf_line_obs(
            kf_slot, ln_per_seg.astype(np.int32), line2d, lvalid & (ln_per_seg >= 0),
            p0=p0, p1=p1, desc=lf.desc, seg_valid=lvalid,
        )
        self.vomap.cull_lines(self.frame_id)
        # Newly created map lines become inheritable by the next frame's
        # frame-to-frame channel.
        feed = self._prev_line_feed
        if feed is not None and feed["fid"] == self.frame_id:
            feed["gid"] = ln_per_seg.astype(np.int32).copy()

    def _fine_manhattan(self) -> None:
        """The fine Manhattan init (hfvo_tpu/tracking/tracker.py:2083-2131;
        reference: MultiViewManhInit, src/Optimizer.cc:3942-4338, triggered
        4 keyframes after the coarse init, src/LocalMapping.cc:100-110): a
        result computed at an earlier keyframe is applied first; then, once
        4 keyframes and 12 axis-tagged map lines exist, the LM runs over the
        tagged lines' directions, each weighted by its observations, and its
        result waits for the next keyframe."""
        if self._manh_fine_pending is not None:
            R_new = self._manh_fine_pending
            self._manh_fine_pending = None
            if np.isfinite(R_new).all():
                self._set_manhattan(R_new.astype(np.float32))
                self._manh_fine_done = True
        if not self.manh_valid or self._manh_fine_done or self.vomap.n_keyframes() < 4:
            return
        lt = self.vomap.lines
        lv = lt.valid & (lt.manh_idx >= 0)
        if lv.sum() < 12:
            return
        dw = lt.X1_w[lv] - lt.X0_w[lv]
        dw = (dw / (np.linalg.norm(dw, axis=1, keepdims=True) + 1e-9)).astype(np.float32)
        CAP = 1024  # the JAX package's fixed size: lines past it are left out
        n = min(len(dw), CAP)
        buf = np.zeros((CAP, 3), np.float32)
        buf[:n] = dw[:n]
        wgt = np.zeros((CAP,), np.float32)
        wgt[:n] = np.minimum(lt.n_obs[lv][:n].astype(np.float32), 8.0).clip(1.0)
        aidx = np.full((CAP,), -1, np.int64)
        aidx[:n] = lt.manh_idx[lv][:n]
        R, _ = manh_ops.multiview_manh_init(
            self._upload(self.R_wm), self._upload(buf), self._upload(wgt), self._upload(aidx),
        )
        self._manh_fine_pending = to_host([R])[0]

    def _add_keyframe_planes(self, kf_slot: int) -> None:
        """The plane part of keyframe insertion (hfvo_tpu/tracking/
        tracker.py:2133-2168): observed planes with neither a full match nor
        a parallel or vertical constraint become new map planes (in the
        world frame, with their scatter), the keyframe stores its plane
        observations, and near-duplicate map planes merge."""
        seg, p_map_idx, p_kind, p_inlier = self._last_plane_out
        pvalid, pi_obs = seg.valid, seg.planes
        plane_id = np.where(pvalid & (p_kind == 0) & p_inlier, p_map_idx, -1).astype(np.int32)
        pidx = np.nonzero(pvalid & (plane_id < 0) & (p_kind != 1) & (p_kind != 2))[0]
        if len(pidx):
            # n_w = R_wc n_c, d_w = d_c + n_c . t_cw (from n_c^T (R X_w + t) + d_c = 0).
            R_cw, t_cw = self.T_cw[:3, :3], self.T_cw[:3, 3]
            n_w = pi_obs[pidx, :3] @ R_cw
            d_w = pi_obs[pidx, 3] + pi_obs[pidx, :3] @ t_cw
            pi_w = np.concatenate([n_w, d_w[:, None]], axis=1).astype(np.float32)
            T_wc = np.linalg.inv(self.T_cw)
            c_w = (T_wc[:3, :3] @ seg.centroids[pidx].T).T + T_wc[:3, 3]
            cov_w = np.einsum("ab,nbc,dc->nad", T_wc[:3, :3], seg.covs[pidx], T_wc[:3, :3])
            pids = self.vomap.add_planes(
                pi_w, c_w.astype(np.float32), seg.counts[pidx], self.frame_id,
                cov_w=cov_w, first_kf=kf_slot,
            )
            created = pids >= 0
            plane_id[pidx[created]] = pids[created]
        self.vomap.add_kf_plane_obs(kf_slot, plane_id, pi_obs, pvalid & (plane_id >= 0))
        self.vomap.merge_planes()
