"""Live-stream driver: the host's equivalent of the reference ROS node.

Port of `hfvo_tpu.stream_cli` (reference:
Examples/ROS/ORB_SLAM2/src/ros_rgbd.cc — builds the System, subscribes to
the RGB + registered-depth topics through an ApproximateTime(10)
synchronizer, forwards each synced pair to TrackRGBD with the RGB
timestamp, and on shutdown saves KeyFrameTrajectory.txt,
ros_rgbd.cc:60-83,112). It runs on the card unless `--device cpu`.

Usage (subscriber / SLAM side):
    python -m hfvo_tpu_torch.stream_cli SETTINGS_YAML [--port N] [--kf-out f.txt]

Publisher side (sensor analog), from any process:
    from hfvo_tpu_torch.io.stream import send_frame, CH_RGB, CH_DEPTH, CH_EOF
    sock = socket.create_connection((host, port))
    send_frame(sock, CH_RGB, stamp, gray_u8)
    send_frame(sock, CH_DEPTH, stamp, depth_u16_mm)
    ...
    send_frame(sock, CH_EOF, 0.0, None)
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional

import numpy as np


def main(argv=None, listening: Optional[Callable[[int], None]] = None) -> int:
    """Run the driver until the publisher sends EOF or disconnects.
    `listening`, when given, is called with the bound port once the server
    accepts connections (for an in-process publisher)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("settings", help="settings YAML (reference format)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0, help="0 = ephemeral")
    ap.add_argument(
        "--queue-size", type=int, default=10,
        help="per-channel sync queue (reference: sync_pol(10), ros_rgbd.cc:73)",
    )
    ap.add_argument(
        "--max-interval", type=float, default=None,
        help="reject RGB/depth pairs farther apart than this (seconds)",
    )
    ap.add_argument(
        "--kf-out", default="KeyFrameTrajectory.txt",
        help="keyframe trajectory saved at shutdown (ros_rgbd.cc:82)",
    )
    ap.add_argument("--out", default=None, help="also save the full trajectory")
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument("--viewer", action="store_true")
    ap.add_argument("--viewer-port", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from .io.stream import FrameStreamServer
    from .system import VOSystem

    system = VOSystem(
        settings_yaml=args.settings, device=args.device, use_local_ba=not args.no_ba,
        use_viewer=args.viewer, viewer_port=args.viewer_port,
    )
    factor = system.cfg.tracking.depth_map_factor
    n = [0]
    t0 = time.perf_counter()

    def grab_rgbd(stamp, rgb, depth):
        # cv_bridge + TrackRGBD analog (ros_rgbd.cc:89-112); depth arrives
        # in the sensor's integer millimetre format, converted here via the
        # configured DepthMapFactor exactly like the file driver (uint16
        # passes through when the factor is 1000).
        if rgb.ndim == 3:  # RGB -> gray (Tracking.cc:241-254)
            rgb = np.rint(
                0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
            ).astype(np.uint8)
        if depth.dtype == np.uint16 and factor not in (1000.0,):
            depth = depth.astype(np.float32) / factor
        res = system.track_rgbd(rgb, depth, float(stamp))
        n[0] += 1
        if n[0] % 50 == 0:
            print(f"frame {n[0]}: state={res.state.name} matches={res.n_matches}")

    server = FrameStreamServer(
        grab_rgbd, host=args.host, port=args.port,
        queue_size=args.queue_size, max_interval=args.max_interval,
    )
    print(f"listening on {args.host}:{server.port}", flush=True)
    if listening is not None:
        listening(server.port)
    server.wait()  # ros::spin() until the publisher sends EOF / drops
    wall = time.perf_counter() - t0

    system.shutdown()
    system.save_keyframe_trajectory_tum(args.kf_out)
    if args.out:
        system.save_trajectory_tum(args.out)
    print(system.extract_times())
    print(
        f"processed {n[0]} frames in {wall:.1f}s "
        f"(sync emitted {server.sync.n_emitted}, dropped {server.sync.n_dropped})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
