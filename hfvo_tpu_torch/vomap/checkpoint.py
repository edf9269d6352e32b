"""Map-state checkpointing: save/restore the whole VO state as arrays.

Port of `hfvo_tpu.vomap.checkpoint` (numpy, copied). The npz keys and the
`meta` layout are the JAX package's, so a file written by either package
loads into the other's `Tracker`. The reference has no map serialization
(SURVEY.md §5.4); here every table is a numpy array, so one compressed npz
captures the map, the keyframe observations, the appearance index and the
Manhattan state.

What a checkpoint does not hold, a load leaves as a fresh tracker has it:
no previous frame's line feed (the port keeps its segments and uint8 image
on the device, and a load drops them, so the next step takes the JAX
package's branch for a tracker with no previous frame), no keyframe-
relative trajectory and no loop-closer state. As in the JAX package, the
local mapper's copy of the Manhattan frame is not restored: it returns with
the next Manhattan init.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _flatten(prefix: str, obj, out: dict) -> None:
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            out[f"{prefix}{f.name}"] = v


def _restore(prefix: str, obj, data) -> None:
    for f in dataclasses.fields(obj):
        key = f"{prefix}{f.name}"
        if key in data:
            getattr(obj, f.name)[...] = data[key]


_TABLES = (("pt_", "points"), ("ln_", "lines"), ("pl_", "planes"), ("kf_", "keyframes"),
           ("kl_", "kf_lines"), ("kp_", "kf_planes"))


def save_checkpoint(path: str, tracker) -> None:
    """Serialize a Tracker's full map + state to a compressed npz."""
    vm = tracker.vomap
    out: dict = {}
    for prefix, name in _TABLES:
        _flatten(prefix, getattr(vm, name), out)
    out["db_hists"] = tracker.kf_db.hists
    out["db_valid"] = tracker.kf_db.valid
    out["meta"] = np.array(
        [
            vm.next_point_slot, vm.next_kf_slot, vm.next_line_slot,
            tracker.frame_id, tracker.last_kf_frame, tracker.n_matches_ref_kf,
            int(tracker.manh_valid), int(tracker._manh_fine_done),
            vm.kf_order_counter, vm.newest_kf_slot,
        ],
        dtype=np.int64,
    )
    out["free_kf_slots"] = np.asarray(vm.free_kf_slots, dtype=np.int64)
    out["T_cw"] = tracker.T_cw
    out["velocity"] = tracker.velocity
    out["R_wm"] = tracker.R_wm
    np.savez_compressed(path, **out)


def load_checkpoint(path: str, tracker) -> None:
    """Restore a Tracker's map + state in place (capacities must match)."""
    from ..tracking.tracker import TrackState

    data = np.load(path)
    vm = tracker.vomap
    for prefix, name in _TABLES:
        _restore(prefix, getattr(vm, name), data)
    tracker.kf_db.hists[...] = data["db_hists"]
    tracker.kf_db.valid[...] = data["db_valid"]
    meta = data["meta"]
    vm.next_point_slot = int(meta[0])
    vm.next_kf_slot = int(meta[1])
    vm.next_line_slot = int(meta[2])
    tracker.frame_id = int(meta[3])
    tracker.last_kf_frame = int(meta[4])
    tracker.n_matches_ref_kf = int(meta[5])
    tracker.manh_valid = bool(meta[6])
    tracker._manh_fine_done = bool(meta[7])
    if len(meta) > 9:
        vm.kf_order_counter = int(meta[8])
        vm.newest_kf_slot = int(meta[9])
    else:  # round-1 checkpoint: slot index was temporal order
        vm.kf_order_counter = int(meta[1])
        vm.newest_kf_slot = int(meta[1]) - 1
        ks = np.nonzero(vm.keyframes.valid)[0]
        vm.keyframes.order[ks] = ks
    vm.free_kf_slots = [int(x) for x in data.get("free_kf_slots", [])]
    tracker.T_cw = data["T_cw"].copy()
    tracker.velocity = data["velocity"].copy()
    tracker.R_wm = data["R_wm"].copy()
    tracker.state = (
        TrackState.OK if vm.n_keyframes() > 0 else TrackState.NOT_INITIALIZED
    )
    tracker.invalidate_map_snapshot()
    tracker._prev_line_feed = None
