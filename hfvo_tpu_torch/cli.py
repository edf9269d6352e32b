"""CLI driver for TUM/ICL RGB-D sequences.

Port of `hfvo_tpu.cli`, the equivalent of the reference's `rgbd_tum`
example (reference: Examples/RGB-D/rgbd_tum.cc:37-207): load the
association file, feed frames to the system, print the mean tracking time
at exit, save the trajectory. It runs on the card unless `--device cpu`.

Usage:
    python -m hfvo_tpu_torch.cli SETTINGS_YAML SEQUENCE_DIR ASSOCIATION_FILE \\
        [--out traj.txt] [--kf-out kf_traj.txt] [--ply map.ply] [--max-frames N] \\
        [--device cuda|cpu]

(The reference also takes a vocabulary blob; relocalization here uses the
in-map descriptor index unless `--vocabulary` names a DBoW2 text file.)
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("settings", help="settings YAML (reference format)")
    ap.add_argument("sequence", help="sequence directory")
    ap.add_argument("association", help="association file")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--kf-out", default=None)
    ap.add_argument("--ply", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument(
        "--loader", choices=["auto", "native", "python"], default="auto",
        help="sequence loader: native C++ prefetcher or pure Python",
    )
    ap.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler Chrome trace of the run, with the program's spans, into this directory",
    )
    ap.add_argument("--checkpoint-out", default=None, help="save the final map state (npz)")
    ap.add_argument("--checkpoint-in", default=None, help="resume from a saved map state")
    ap.add_argument(
        "--vocabulary", default=None,
        help="trained DBoW2 text vocabulary (ORBvoc.txt); default: LSH bank",
    )
    ap.add_argument(
        "--viewer", action="store_true",
        help="spawn the live HTTP viewer (reference: Pangolin Viewer thread, "
        "src/System.cc:108-113)",
    )
    ap.add_argument("--viewer-port", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from . import tracing
    from .io import tum
    from .system import VOSystem

    system = VOSystem(
        settings_yaml=args.settings, device=args.device, use_local_ba=not args.no_ba,
        vocabulary_path=args.vocabulary,
        use_viewer=args.viewer, viewer_port=args.viewer_port,
    )
    factor = system.cfg.tracking.depth_map_factor

    frames = None
    if args.loader in ("auto", "native"):
        from . import native

        if native.native_available():
            frames = native.NativeSequenceLoader(
                args.sequence, args.association, factor,
                max_hw=(system.cfg.camera.height, system.cfg.camera.width),
            )
        elif args.loader == "native":
            raise SystemExit(f"native loader unavailable: {native.build_error()}")
    if frames is None:
        frames = tum.iterate_sequence(args.sequence, args.association, factor)

    if args.checkpoint_in:
        from .vomap.checkpoint import load_checkpoint

        load_checkpoint(args.checkpoint_in, system.tracker)

    prof = None
    if args.profile_dir:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if system.tracker.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        tracing.enable()

    n = 0
    t_start = time.perf_counter()
    try:
        for ts, gray, depth in frames:
            res = system.track_rgbd(gray, depth, ts)
            n += 1
            if n % 50 == 0:
                print(f"frame {n}: state={res.state.name} matches={res.n_matches}")
            if args.max_frames and n >= args.max_frames:
                break
    finally:
        if prof is not None:
            import os

            tracing.disable()
            prof.__exit__(None, None, None)
            os.makedirs(args.profile_dir, exist_ok=True)
            path = os.path.join(args.profile_dir, "trace.json")
            prof.export_chrome_trace(path)
            _merge_spans(path, tracing.drain())
            print(f"profiler trace written to {args.profile_dir}")
        if hasattr(frames, "close"):
            frames.close()
    wall = time.perf_counter() - t_start

    system.shutdown()
    if args.checkpoint_out:
        from .vomap.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint_out, system.tracker)
    system.save_trajectory_tum(args.out)
    if args.kf_out:
        system.save_keyframe_trajectory_tum(args.kf_out)
    if args.ply:
        system.save_point_cloud_ply(args.ply)

    print(system.extract_times())
    print(f"processed {n} frames in {wall:.1f}s ({n / max(wall, 1e-9):.1f} fps)")
    print(f"trajectory saved to {args.out}")
    return 0


def _merge_spans(path: str, rec) -> None:
    """Add the recorder's spans and counts to a torch.profiler Chrome trace,
    on the row of the thread that ran them."""
    import json
    import os
    import threading

    from . import tracing

    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(tracing.chrome_events(
        rec, int(doc.get("baseTimeNanoseconds", 0)), pid=os.getpid(), tid=threading.get_native_id()))
    with open(path, "w") as f:
        json.dump(doc, f)


if __name__ == "__main__":
    sys.exit(main())
