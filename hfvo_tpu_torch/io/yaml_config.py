"""OpenCV-FileStorage-style YAML settings loader.

Port of `hfvo_tpu.io.yaml_config` (numpy-free, copied): the same parser
and the same mapping onto the port's `VOConfig`, field for field.

The reference reads `Examples/RGB-D/*.yaml` through `cv::FileStorage`
(reference: src/Tracking.cc:53-178 eager reads + include/Config.h lazy
`Config::Get<T>`). Those files are flat `Section.key: value` pairs under a
`%YAML:1.0` header. This parser needs no OpenCV: it understands scalars,
the flat dotted keys, and ignores comments, and maps the union of the
reference's keys onto `VOConfig`.
"""
from __future__ import annotations

import os
from typing import Dict

from ..config import (
    Capacities,
    LineConfig,
    ManhattanConfig,
    OrbConfig,
    PlaneConfig,
    TrackingConfig,
    VOConfig,
)
from ..geometry.camera import Intrinsics


def parse_opencv_yaml(path: str) -> Dict[str, float]:
    """Flat key -> float/str dict from an OpenCV-style YAML file."""
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%YAML") or line.startswith("---"):
                continue
            if ":" not in line:
                continue
            key, val = line.split(":", 1)
            key = key.strip().strip('"')
            val = val.strip().strip('"')
            if not val:
                continue
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val  # type: ignore[assignment]
    return out


def config_from_yaml(path: str) -> VOConfig:
    """Build a VOConfig from a reference-format settings YAML."""
    kv = parse_opencv_yaml(path)

    def g(key: str, default: float) -> float:
        v = kv.get(key, default)
        return float(v) if not isinstance(v, str) else default

    cam = Intrinsics(
        fx=g("Camera.fx", 535.4),
        fy=g("Camera.fy", 539.2),
        cx=g("Camera.cx", 320.1),
        cy=g("Camera.cy", 247.6),
        k1=g("Camera.k1", 0.0),
        k2=g("Camera.k2", 0.0),
        p1=g("Camera.p1", 0.0),
        p2=g("Camera.p2", 0.0),
        k3=g("Camera.k3", 0.0),
        bf=g("Camera.bf", 40.0),
        width=int(g("Camera.width", 640)),
        height=int(g("Camera.height", 480)),
    )
    orb = OrbConfig(
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        scale_factor=g("ORBextractor.scaleFactor", 1.2),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
    )
    lines = LineConfig(
        n_features=int(g("LSDextractor.nLSDFeature", 200)),
        n_levels=int(g("LSDextractor.nLevels", 1)),
    )
    planes = PlaneConfig(
        distance_threshold=g("Plane.DistanceThreshold", 0.04),
        angle_info=g("Plane.AngleInfo", 0.5),
        distance_info=g("Plane.DistanceInfo", 100.0),
        parallel_info=g("Plane.ParallelInfo", 0.5),
        vertical_info=g("Plane.VerticalInfo", 0.5),
        chi=g("Plane.Chi", 100.0),
        vp_chi=g("Plane.VPChi", 50.0),
        association_dis_ref=g("Plane.AssociationDisRef", 0.15),
        association_ang_ref=g("Plane.AssociationAngRef", 0.2618),
        vertical_threshold=g("Plane.VerticalThreshold", 0.08716),
    )
    fps = g("Camera.fps", 30.0)
    mask_path = kv.get("Mask.path")
    if isinstance(mask_path, str):
        if not os.path.exists(mask_path):
            mask_path = None
    else:
        # Reference behavior: a ./masks/mask.png next to the working dir is
        # picked up automatically when present (src/Tracking.cc:82-86).
        mask_path = "./masks/mask.png" if os.path.exists("./masks/mask.png") else None
    tracking = TrackingConfig(
        th_depth=g("ThDepth", 40.0),
        depth_map_factor=g("DepthMapFactor", 5000.0),
        max_frames_between_kf=int(fps) if fps > 0 else 30,
        static_mask_path=mask_path,
    )
    return VOConfig(
        camera=cam,
        orb=orb,
        lines=lines,
        planes=planes,
        manhattan=ManhattanConfig(),
        tracking=tracking,
        cap=Capacities(),
        fps=fps,
    )
