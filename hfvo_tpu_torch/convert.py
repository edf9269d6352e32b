"""State and constant tables carried between `hfvo_tpu` and this port.

Both packages keep the tracker's host state in the same numpy layout (the
`VOMap` tables, pose, velocity, counters, keyframe database, trajectory
log, with lines the previous frame's line feed and the last step's line
result, with planes the last step's plane result, the Manhattan frame
(mirrored into the local mapper for BA's axis terms), the mapper's
count of local BA runs, the early-loss reset flag and the loop closer's
state), so a tracker's state can be read from either package's
`Tracker` and loaded into this port's. With that, a test can step both
trackers from one identical map, and a batch tracker's S states can be
loaded the same way. Nothing here imports JAX: the reading side
works by attribute and key name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from .bow import vocab
from .ops import lines3d, manhattan, orb

_TABLES = ("points", "lines", "planes", "keyframes", "kf_lines", "kf_planes")
_MAP_SCALARS = (
    "next_point_slot", "next_kf_slot", "next_line_slot", "next_plane_slot",
    "kf_order_counter", "newest_kf_slot",
)
_TRACKER_SCALARS = ("frame_id", "last_kf_frame", "n_matches_ref_kf")
_SEG_FIELDS = ("planes", "centroids", "counts", "valid", "covs")


def _np(a) -> np.ndarray:
    """A host numpy copy of a numpy, JAX or torch array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu()
    return np.array(a)


def _line_feed_numpy(feed) -> Optional[Dict[str, Any]]:
    """The previous-frame line feed as numpy. The descriptors are the
    float32 copy: this port's feed holds only that; the JAX package's host
    copy of a tracked frame is float16 (its wire format), and its device
    feed (`dev`) keeps float32."""
    if feed is None:
        return None
    dev = feed.get("dev")
    if dev is not None and hasattr(dev, "gray"):  # this port's LineFeed
        p0, p1, desc, valid, gray = dev
    else:
        p0, p1, valid, gray = feed["p0"], feed["p1"], feed["valid"], feed["gray"]
        desc = dev[2] if dev else feed["desc"]
    out = {"fid": int(feed["fid"]), "gid": np.array(feed["gid"], np.int32)}
    for key, val, dt in (("p0", p0, np.float32), ("p1", p1, np.float32),
                         ("desc", desc, np.float32), ("valid", valid, bool),
                         ("gray", gray, np.uint8)):
        out[key] = _np(val).astype(dt)
    return out


def _last_line_out_numpy(llo) -> Optional[Dict[str, Any]]:
    if llo is None:
        return None
    lf, l3d, ln_per_seg = llo
    return {
        "lf": {k: _np(v) for k, v in lf._asdict().items()},
        "l3d": {k: _np(v) for k, v in l3d._asdict().items()},
        "ln_per_seg": np.array(ln_per_seg, np.int32),
    }


def _last_plane_out_numpy(lpo) -> Optional[Dict[str, Any]]:
    """The last step's plane result: the segmentation's plane rows (its
    per-block maps have no consumer and are left out) and the association."""
    if lpo is None:
        return None
    seg, map_idx, kind, inlier = lpo
    return {
        "seg": {k: _np(getattr(seg, k)) for k in _SEG_FIELDS},
        "map_idx": np.array(map_idx, np.int32),
        "kind": np.array(kind, np.int32),
        "inlier": np.array(inlier, bool),
    }


def _manhattan_numpy(tracker: Any) -> Dict[str, Any]:
    pending = getattr(tracker, "_manh_fine_pending", None)
    axes = getattr(tracker, "_last_axes", None)
    return {
        "R_wm": np.array(tracker.R_wm, np.float32),
        "manh_valid": bool(tracker.manh_valid),
        "manh_fine_done": bool(tracker._manh_fine_done),
        "manh_fine_pending": None if pending is None else _np(pending).astype(np.float32),
        "last_axes": None if axes is None else (_np(axes[0]).astype(np.float32), _np(axes[1]).astype(np.int32)),
    }


def _loop_closer_numpy(tracker: Any) -> Optional[Dict[str, Any]]:
    lc = getattr(tracker, "loop_closer", None)
    if lc is None:
        return None
    return {
        "n_loops_closed": int(lc.n_loops_closed),
        "last_loop_order": int(lc.last_loop_order),
        "consistency_count": int(lc._consistency_count),
        "consistent_group": sorted(int(k) for k in lc._consistent_group),
    }


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
        "line_feed": _line_feed_numpy(getattr(tracker, "_prev_line_feed", None)),
        "last_line_out": _last_line_out_numpy(getattr(tracker, "_last_line_out", None)),
        "last_plane_out": _last_plane_out_numpy(getattr(tracker, "_last_plane_out", None)),
        "manhattan": _manhattan_numpy(tracker),
        "n_ba_runs": int(tracker.mapper.n_ba_runs),
        "auto_reset": bool(tracker.auto_reset),
        "loop_closer": _loop_closer_numpy(tracker),
        **{k: int(getattr(tracker, k)) for k in _TRACKER_SCALARS},
    }


def tracker_state_from_numpy(tracker: Any, state: Dict[str, Any]) -> None:
    """Fill this port's `Tracker` with a host state from
    `tracker_state_numpy`. Map tables must have the same capacities."""
    from .ops.lines import LineFeatures
    from .tracking.tracker import LineFeed, TrackState, _host_plane_step

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
    feed = state.get("line_feed")
    tracker._prev_line_feed = None if feed is None else {
        "fid": int(feed["fid"]),
        "gid": np.array(feed["gid"], np.int32),
        "dev": LineFeed(*(
            tracker._upload(np.array(feed[k])) for k in ("p0", "p1", "desc", "valid", "gray")
        )),
    }
    llo = state.get("last_line_out")
    tracker._last_line_out = None if llo is None else (
        LineFeatures(**{k: np.array(v) for k, v in llo["lf"].items()})._replace(
            desc=np.array(llo["lf"]["desc"], np.float32)),
        lines3d.Lines3D(**{k: np.array(v) for k, v in llo["l3d"].items()}),
        np.array(llo["ln_per_seg"], np.int32),
    )
    lpo = state.get("last_plane_out")
    tracker._last_plane_out = None if lpo is None else _host_plane_step(
        *(np.array(lpo["seg"][k]) for k in _SEG_FIELDS),
        np.array(lpo["map_idx"]), np.array(lpo["kind"]), np.array(lpo["inlier"], bool),
    )
    m = state["manhattan"]
    tracker.R_wm = np.array(m["R_wm"], np.float32)
    tracker.manh_valid = bool(m["manh_valid"])
    tracker.mapper.R_wm = tracker.R_wm if tracker.manh_valid else None
    tracker.mapper.manh_valid = tracker.manh_valid
    tracker._manh_fine_done = bool(m["manh_fine_done"])
    pending = m["manh_fine_pending"]
    tracker._manh_fine_pending = None if pending is None else np.array(pending, np.float32)
    axes = m["last_axes"]
    tracker._last_axes = None if axes is None else (np.array(axes[0]), np.array(axes[1]))
    tracker.mapper.n_ba_runs = int(state["n_ba_runs"])
    tracker.auto_reset = bool(state.get("auto_reset", True))
    lc = state.get("loop_closer")
    if lc is not None:
        tracker.loop_closer.n_loops_closed = int(lc["n_loops_closed"])
        tracker.loop_closer.last_loop_order = int(lc["last_loop_order"])
        tracker.loop_closer._consistency_count = int(lc["consistency_count"])
        tracker.loop_closer._consistent_group = set(lc["consistent_group"])
    tracker.invalidate_map_snapshot()


def batch_tracker_state_from_numpy(batch: Any, states: List[Dict[str, Any]]) -> None:
    """Fill this port's `BatchTracker` with S tracker states, one
    `tracker_state_numpy` each, in sequence order (for instance of the JAX
    package's `BatchTracker`, `bt.trackers[s]`)."""
    if len(states) != len(batch.trackers):
        raise ValueError(f"{len(states)} states for a batch of {len(batch.trackers)} sequences")
    for tr, state in zip(batch.trackers, states):
        tracker_state_from_numpy(tr, state)


def constants_from_numpy(
    brief_pattern: np.ndarray,
    bin_diff_mats: np.ndarray,
    prototypes: np.ndarray,
    line_pairs: Optional[np.ndarray] = None,
    manhattan_hyps: Optional[np.ndarray] = None,
) -> None:
    """Check that this port's BRIEF pattern, steered-BRIEF difference bank,
    LSH prototypes and (when given) 3D-line RANSAC hypothesis pairs and
    fixed Manhattan rotation hypotheses equal the given arrays (the JAX
    package's `orb.BRIEF_PATTERN`, `orb.BIN_DIFF_MATS`, `vocab.PROTOTYPES`,
    `lines3d._PAIRS`, `manhattan._FIXED_HYPS`); raises ValueError on the
    first table that differs."""
    tables = [
        ("BRIEF_PATTERN", orb.BRIEF_PATTERN, brief_pattern),
        ("BIN_DIFF_MATS", orb.bin_diff_mats(), bin_diff_mats),
        ("PROTOTYPES", vocab.PROTOTYPES, prototypes),
    ]
    if line_pairs is not None:
        tables.append(("lines3d._PAIRS", lines3d._PAIRS, line_pairs))
    if manhattan_hyps is not None:
        tables.append(("manhattan._FIXED_HYPS", manhattan._FIXED_HYPS, manhattan_hyps))
    for name, mine, theirs in tables:
        theirs = np.asarray(theirs)
        if mine.shape != theirs.shape or not np.array_equal(mine, theirs):
            raise ValueError(f"constant table {name} differs from the given array")
