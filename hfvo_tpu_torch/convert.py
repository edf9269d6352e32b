"""State and constant tables carried between `hfvo_tpu` and this port.

Both packages keep the tracker's host state in the same numpy layout (the
`VOMap` tables, pose, velocity, counters, keyframe database, trajectory
log), so a tracker's state can be read from either package's `Tracker` and
loaded into this port's. With that, a test can step both trackers from one
identical map. Nothing here imports JAX: the reading side works by
attribute name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from .bow import vocab
from .ops import orb

_TABLES = ("points", "lines", "planes", "keyframes", "kf_lines", "kf_planes")
_MAP_SCALARS = (
    "next_point_slot", "next_kf_slot", "next_line_slot", "next_plane_slot",
    "kf_order_counter", "newest_kf_slot",
)
_TRACKER_SCALARS = ("frame_id", "last_kf_frame", "n_matches_ref_kf")


def tracker_state_numpy(tracker: Any) -> Dict[str, Any]:
    """Host state of a `Tracker` (of either package) as numpy arrays and
    Python scalars."""
    vm = tracker.vomap
    return {
        "tables": {
            name: {
                f.name: np.array(getattr(getattr(vm, name), f.name))
                for f in dataclasses.fields(getattr(vm, name))
            }
            for name in _TABLES
        },
        "map_scalars": {k: int(getattr(vm, k)) for k in _MAP_SCALARS},
        "free_kf_slots": [int(k) for k in vm.free_kf_slots],
        "T_cw": np.array(tracker.T_cw, np.float32),
        "velocity": np.array(tracker.velocity, np.float32),
        "state": tracker.state.name,
        "last_n_matches": int(tracker._last_n_matches),
        "kf_db_hists": np.array(tracker.kf_db.hists),
        "kf_db_valid": np.array(tracker.kf_db.valid),
        "traj_rel": [(int(r), np.array(T, np.float32)) for r, T in tracker._traj_rel],
        **{k: int(getattr(tracker, k)) for k in _TRACKER_SCALARS},
    }


def tracker_state_from_numpy(tracker: Any, state: Dict[str, Any]) -> None:
    """Fill this port's `Tracker` with a host state from
    `tracker_state_numpy`. Map tables must have the same capacities."""
    from .tracking.tracker import TrackState

    vm = tracker.vomap
    for name, fields in state["tables"].items():
        table = getattr(vm, name)
        for key, value in fields.items():
            dst = getattr(table, key)
            if dst.shape != value.shape:
                raise ValueError(
                    f"{name}.{key}: shape {value.shape} does not match this "
                    f"tracker's {dst.shape} (capacities differ)"
                )
            setattr(table, key, np.array(value, dtype=dst.dtype))
    for k, v in state["map_scalars"].items():
        setattr(vm, k, int(v))
    vm.free_kf_slots = list(state["free_kf_slots"])
    tracker.T_cw = np.array(state["T_cw"], np.float32)
    tracker.velocity = np.array(state["velocity"], np.float32)
    tracker.state = TrackState[state["state"]]
    tracker._last_n_matches = int(state["last_n_matches"])
    tracker.kf_db.hists = np.array(state["kf_db_hists"], np.float32)
    tracker.kf_db.valid = np.array(state["kf_db_valid"], bool)
    tracker._traj_rel = [(int(r), np.array(T, np.float32)) for r, T in state["traj_rel"]]
    for k in _TRACKER_SCALARS:
        setattr(tracker, k, int(state[k]))
    tracker.invalidate_map_snapshot()


def constants_from_numpy(
    brief_pattern: np.ndarray, bin_diff_mats: np.ndarray, prototypes: np.ndarray
) -> None:
    """Check that this port's BRIEF pattern, steered-BRIEF difference bank
    and LSH prototypes equal the given arrays (the JAX package's
    `orb.BRIEF_PATTERN`, `orb.BIN_DIFF_MATS`, `vocab.PROTOTYPES`); raises
    ValueError on the first table that differs."""
    for name, mine, theirs in (
        ("BRIEF_PATTERN", orb.BRIEF_PATTERN, brief_pattern),
        ("BIN_DIFF_MATS", orb.bin_diff_mats(), bin_diff_mats),
        ("PROTOTYPES", vocab.PROTOTYPES, prototypes),
    ):
        theirs = np.asarray(theirs)
        if mine.shape != theirs.shape or not np.array_equal(mine, theirs):
            raise ValueError(f"constant table {name} differs from the given array")
