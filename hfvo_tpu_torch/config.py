"""Typed configuration — the union of the reference's YAML knobs.

The reference reads its settings through two overlapping mechanisms (eager
`cv::FileStorage` reads in constructors, reference: src/Tracking.cc:53-178, and
a lazy `Config::Get<T>` singleton, reference: include/Config.h:15-20). Here the
whole surface is one frozen dataclass; per-dataset presets mirror
`Examples/RGB-D/*.yaml` (TUM1/2/3, ICL).

Static capacity fields (``max_*``) are this framework's addition: every
per-frame and map-level array has a fixed capacity + validity mask so that all
jitted code sees static shapes (SURVEY.md §7 "data-dependent sizes everywhere").

The dataclasses, defaults and presets are those of `hfvo_tpu.config`; the
port keeps fixed capacities too, so its tensors have the reference's shapes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from .geometry.camera import Intrinsics


@dataclass(frozen=True)
class OrbConfig:
    """ORB extractor knobs (reference: Examples/RGB-D/TUM3.yaml ORBextractor.*)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # TPU-native additions: static per-level candidate capacity before the
    # budgeted top-k selection (replaces the quadtree DistributeOctTree,
    # reference: src/ORBextractor.cc:537).
    max_candidates_per_level: int = 4096
    grid_cell: int = 16  # cell size (px) for spatial-uniformity bucketing
    patch_size: int = 31
    edge_threshold: int = 19


@dataclass(frozen=True)
class LineConfig:
    """Line extractor knobs (reference: LSDextractor.* YAML keys + LSD defaults)."""

    n_features: int = 200
    n_levels: int = 1
    min_length_px: float = 30.0
    min_length_3d: float = 0.02  # reference: src/Frame.cc:1290
    depth_samples: int = 20  # samples along a segment for 3D fit (Frame.cc:1211)
    min_valid_depth_samples: int = 5  # reference: src/Frame.cc:1241
    # Frame-to-frame line search (reference: LSDmatcher::
    # SearchByGeomNApearance, src/LSDmatcher.cpp:36): descriptor + warped
    # geometry gates for inheriting the previous frame's map-line matches.
    f2f_max_desc_dist: float = 0.5
    f2f_max_mid_dist: float = 40.0
    f2f_max_angle: float = 0.2
    # Manhattan-rotation-seeded optical-flow recovery of unmatched lines
    # (reference: LSDmatcher::optical_flow_line, src/LSDmatcher.cpp:158-520,
    # called every frame from TrackWithMotionModel, src/Tracking.cc:2299).
    lk_recovery: bool = True
    lk_samples: int = 16
    lk_max_perp: float = 10.0  # recovered line vs projected map line (px)
    lk_max_angle: float = 0.2


@dataclass(frozen=True)
class PlaneConfig:
    """Plane segmentation/association knobs (reference: Config::Get("Plane.*"),
    src/PlaneMatcher.cpp:10-70, src/Frame.cc:2104-2274)."""

    distance_threshold: float = 0.04
    angle_info: float = 0.5
    distance_info: float = 100.0
    parallel_info: float = 0.5
    vertical_info: float = 0.5
    chi: float = 100.0
    vp_chi: float = 50.0
    association_dis_ref: float = 0.15
    association_ang_ref: float = 0.2618  # ~15 deg
    # |n1.n2| bound under which two planes count as perpendicular when
    # seeding the Manhattan frame (reference: Plane.VerticalThreshold =
    # 0.08716 (85 deg) in Examples/RGB-D/TUM3.yaml:102, consumed by
    # Map::FindManhattan via mfVerTh, src/Tracking.cc:177,658).
    vertical_threshold: float = 0.08716
    voxel_size: float = 0.1  # reference: src/Frame.cc:2130 voxel downsample
    block: int = 10  # AHC seed-block size in pixels
    max_points_per_plane: int = 512  # downsampled cloud capacity per landmark


@dataclass(frozen=True)
class ManhattanConfig:
    """Manhattan/structural thresholds (reference: src/Manhattan.cpp:28-34,
    src/Tracking.cc:953-1170)."""

    par_deg_2d3d: float = 3.0
    perp_deg_2d3d: float = 87.0
    par_deg_map: float = 5.0
    perp_deg_map: float = 85.0
    normal_cone: float = 0.2018  # conic gate half-angle for normals (Tracking.cc:961)
    line_cone: float = 0.1018  # conic gate half-angle for line dirs
    meanshift_kernel: float = 20.0  # exp(-20 * ||x||^2) (Tracking.cc:1161)
    coarse_success_rate: float = 0.95  # reference: src/Tracking.cc:573
    coarse_hypotheses: int = 64  # random-rotation hypotheses for coarse init
    # Line-axis parallelism edges in local BA (reference:
    # ParEptsNVector3DSingleFrame, Optimizer.cc:3382-3410): information on
    # the cross(dir, axis) residual per Manhattan-assigned map line.
    line_axis_info: float = 100.0
    # Cross-line par/perp structural edges in local BA (reference:
    # multi-frame par/perp edges, include/g2oMSC.h:332-559): information on
    # the cross/dot residual per discovered line pair.
    line_pair_info: float = 50.0
    # Per-axis rotation anchors in the pose LM (framework addition; the
    # mean-shift axis directions are absolute so they pin the (t_x, r_y)
    # valley — see solve/lm.py pose_optimization).
    rot_prior_weight: float = 800.0  # information per supporting normal
    # (1/sigma^2 with sigma ~ 2 degrees per normal; total anchor weight
    # scales with support so a wall of normals outvotes a handful of
    # confidently-wrong point matches, while sparse support defers to them)
    rot_prior_bias: float = 3e-3  # rad; mean-shift systematic error floor.
    # Random noise averages out over N normals but the systematic bias
    # doesn't, so axis information saturates at 1/bias^2:
    # w = w0*sup / (1 + w0*sup*bias^2).
    rot_prior_max_correction: float = 0.09  # rad; reject basin jumps
    rot_prior_min_support: int = 100  # normals within cone to trust an axis


@dataclass(frozen=True)
class TrackingConfig:
    """Tracking-loop policy knobs (reference: src/Tracking.cc)."""

    th_depth: float = 40.0  # close/far stereo threshold factor (YAML ThDepth)
    depth_map_factor: float = 5000.0
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30  # = fps
    min_matches_track: int = 20
    min_matches_track_local: int = 30
    # Absolute coverage floor for keyframe insertion: below this many
    # tracked matches the local map no longer covers the view regardless
    # of the ratio rule. Must stay well below typical per-frame match
    # counts or every frame becomes a keyframe.
    min_coverage_kf: int = 60
    local_map_size_kf: int = 80
    # chi2 gates (reference: src/Optimizer.cc:1175-1179)
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    chi2_line: float = 3.84
    # Metric 3D point residual (framework addition; rescues points-only
    # tracking in planar views — see solve/lm.py PoseObs). 0 disables;
    # off by default because the full hybrid recovers better through its
    # line/plane edges (the 3D term anchors to drifted map points).
    chi2_3d: float = 7.815
    inv_sigma2_3d: float = 0.0
    # 30-bin rotation-consistency histogram in projection matching
    # (reference: mbCheckOrientation, src/ORBmatcher.cc:37-39).
    check_rotation_consistency: bool = True
    # Viewing-direction gate on local-map candidates: reject a point whose
    # mean observation direction is > 60 deg from the current viewing ray
    # (reference: Frame::isInFrustum viewCos < viewingCosLimit = 0.5,
    # src/Frame.cc:1371-1427, called from SearchLocalPoints,
    # src/Tracking.cc:3227).
    check_view_cos: bool = True
    view_cos_limit: float = 0.5
    # Epipolar triangulation of new map points at keyframe insertion
    # (reference: LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:335
    # — the only way landmarks beyond the depth range enter the map).
    triangulate_new_points: bool = True
    # Two-view line triangulation with third-view verification (reference:
    # LocalMapping::CreateNewMapLinesConstraint, src/LocalMapping.cc:1064).
    triangulate_new_lines: bool = True
    # Optional static feature mask (PNG, nonzero = usable) excluding
    # known-dynamic regions from point/line features (reference loads
    # ./masks/mask.png at startup, src/Tracking.cc:82-86).
    static_mask_path: str | None = None
    # Upload depth subsampled by this stride (uint16, stride^2 fewer bytes)
    # and nearest-upsample on device. Host->device bandwidth is the
    # per-frame bottleneck on RTT/bandwidth-bound transports; depth
    # consumers (keypoint depth, stride-8 normals, plane segmentation, line
    # fits) tolerate the (stride-1)-px quantization (chi2/RANSAC gates
    # absorb edge cases). 1 = full resolution; 2 = the validated default;
    # 4 trades ~2x depth-edge error for another 115 KB/frame of wire
    # (gated by the golden-ATE tests before any preset enables it).
    depth_upload_stride: int = 2


@dataclass(frozen=True)
class Capacities:
    """Fixed array capacities for jit-static shapes (framework addition)."""

    keypoints: int = 1024
    lines: int = 256
    planes: int = 32
    normals: int = 2048  # subsampled surface normals per frame
    map_points: int = 32768
    map_lines: int = 4096
    map_planes: int = 256
    keyframes: int = 512
    local_points: int = 8192  # local-map point window used for tracking
    local_lines: int = 1024
    local_kfs: int = 16  # keyframes in local BA window
    ba_fixed_kfs: int = 8
    ba_edges: int = 16384
    ba_line_pairs: int = 256  # line-endpoint pairs (axis edges) in local BA
    ba_line_pair_edges: int = 512  # cross-line par/perp edges in local BA


@dataclass(frozen=True)
class VOConfig:
    camera: Intrinsics = Intrinsics(
        fx=535.4, fy=539.2, cx=320.1, cy=247.6, bf=40.0, width=640, height=480
    )
    orb: OrbConfig = OrbConfig()
    lines: LineConfig = LineConfig()
    planes: PlaneConfig = PlaneConfig()
    manhattan: ManhattanConfig = ManhattanConfig()
    tracking: TrackingConfig = TrackingConfig()
    cap: Capacities = Capacities()
    fps: float = 30.0
    use_lines: bool = True
    use_planes: bool = True
    use_manhattan: bool = True

    def replace(self, **kw) -> "VOConfig":
        return dataclasses.replace(self, **kw)


def tum3_config() -> VOConfig:
    """TUM freiburg3 preset (reference: Examples/RGB-D/TUM3.yaml)."""
    return VOConfig(
        camera=Intrinsics(fx=535.4, fy=539.2, cx=320.1, cy=247.6, bf=40.0),
        tracking=TrackingConfig(depth_map_factor=5000.0),
    )


def tum1_config() -> VOConfig:
    """TUM freiburg1 preset (reference: Examples/RGB-D/TUM1.yaml)."""
    return VOConfig(
        camera=Intrinsics(
            fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
            k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
            bf=40.0,
        ),
        tracking=TrackingConfig(depth_map_factor=5000.0),
    )


def tum2_config() -> VOConfig:
    """TUM freiburg2 preset (reference: Examples/RGB-D/TUM2.yaml)."""
    return VOConfig(
        camera=Intrinsics(
            fx=520.908620, fy=521.007327, cx=325.141442, cy=249.701764,
            k1=0.231222, k2=-0.784899, p1=-0.003257, p2=-0.000105, k3=0.917205,
            bf=40.0,
        ),
        tracking=TrackingConfig(depth_map_factor=5208.0),
    )


def icl_config() -> VOConfig:
    """ICL-NUIM preset (reference: Examples/RGB-D/ICL.yaml)."""
    return VOConfig(
        camera=Intrinsics(fx=481.20, fy=-480.00, cx=319.50, cy=239.50, bf=40.0),
        tracking=TrackingConfig(depth_map_factor=5000.0),
    )


def points_only(cfg: VOConfig) -> VOConfig:
    """The configuration this port's slice runs: points-only tracking.

    Turns off the line, plane and Manhattan stages and the keyframe-path
    triangulation (epipolar points and two-view lines), keeping every other
    knob of `cfg`. This is the ORB-SLAM2-lineage points tracker of the
    reference; the other stages arrive with their own slices."""
    return cfg.replace(
        use_lines=False,
        use_planes=False,
        use_manhattan=False,
        tracking=dataclasses.replace(
            cfg.tracking,
            triangulate_new_points=False,
            triangulate_new_lines=False,
        ),
    )


def points_and_lines(cfg: VOConfig) -> VOConfig:
    """The configuration of the port's second slice: point + line tracking.

    `cfg` with the line stages on (Hough segments, 3D line fits, structural
    refinement, line projection and frame-to-frame searches, flow-based
    line recovery, line and direction edges in the pose LM, line fusion),
    planes and Manhattan off, and the keyframe-path triangulation (epipolar
    points and two-view lines) off; every other knob of `cfg` is kept."""
    return points_only(cfg).replace(use_lines=True)


def full_step(cfg: VOConfig) -> VOConfig:
    """The configuration of the port's full tracking step: `cfg` with its
    own line, plane and Manhattan flags (all on in every preset, the JAX
    package's default step) and the keyframe-path triangulation (epipolar
    points and two-view lines) off, which arrives with the keyframe-path
    slice; every other knob of `cfg` is kept."""
    return cfg.replace(
        tracking=dataclasses.replace(
            cfg.tracking, triangulate_new_points=False, triangulate_new_lines=False,
        ),
    )
