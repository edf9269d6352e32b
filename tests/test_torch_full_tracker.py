"""The full tracking step as a whole: hfvo_tpu's Tracker and the port's on
the same frames and configuration (tum3 with lines, planes and Manhattan
axes on, the JAX package's default step, with no triangulation and local BA
and loop closing off).

(a) JAX and port over orbit frames 1-12 (12 is the first frame with 3
    segmented planes): per-frame pose within 2 mm and 0.1 deg, the same
    keyframe decisions, the same `manh_valid`, the same world Manhattan
    frame modulo a proper signed axis permutation (1e-5), and the same plane
    association (kind and map row) for every segmented plane. Both start at
    frame 1 of the orbit, as test_torch_lines_tracker.py does (frame 0
    looks straight at a wall, where the X0/X1 order of a 3D line fit is a
    rounding artefact in the JAX package itself).
(b) ATE over those frames within 1.5x the JAX run's.
(c) One step from the JAX state after frame 12, carried across with
    tracker_state_from_numpy: pose within 5e-4, the same point matches,
    plane association and Manhattan frame.
(d) Keyframe plumbing the orbit never reaches, on a JAX and a port tracker
    loaded with the same state (no JAX compile besides the fine init's):
    new map planes for two unmatched observed planes and a merge of a
    near-duplicate; and the fine Manhattan init dispatched at the keyframe
    where 4 keyframes and 12 axis-tagged map lines exist, applied at the
    next keyframe and not before. Tables equal; the fine init's rotation
    within 1e-5.
The JAX tracker runs once, in one module fixture: its full step compiles
for about 65 s.
"""
import dataclasses

import numpy as np
import pytest

from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.tracking.tracker import Tracker as JaxTracker
from hfvo_tpu_torch import convert
from hfvo_tpu_torch.bow.vocab import compute_words
from hfvo_tpu_torch.config import full_step, points_and_lines, tum3_config
from hfvo_tpu_torch.io import evaluate
from hfvo_tpu_torch.ops import fast, lines
from hfvo_tpu_torch.parallel.multiseq import BatchTracker
from hfvo_tpu_torch.system import VOSystem
from hfvo_tpu_torch.testing import synthetic as tsyn
from hfvo_tpu_torch.tracking.frontend import extract_frame
from hfvo_tpu_torch.tracking.tracker import Tracker, TrackState, _feats_to_host
from torch_helpers import same_frame, t

START, END = 1, 13  # frames 1..12
N_FRAMES = END + 1  # frame 13 for the carried step


def _jax_cfg():
    c = jax_tum3()
    return c.replace(tracking=dataclasses.replace(
        c.tracking, triangulate_new_points=False, triangulate_new_lines=False))


def _port_cfg():
    return full_step(tum3_config())


@pytest.fixture(scope="module")
def frames():
    return tsyn.render_sequence(n=N_FRAMES, seed=0)


def _record(tracker, res):
    po = tracker._last_plane_out
    return dict(
        T=np.asarray(res.T_cw), kf=bool(res.is_keyframe), state=res.state.name,
        n=int(res.n_matches), manh=bool(tracker.manh_valid), R_wm=np.array(tracker.R_wm),
        pvalid=np.array(po[0].valid), kind=np.array(po[2]), map_idx=np.array(po[1]),
    )


@pytest.fixture(scope="module")
def jax_run(frames):
    """hfvo_tpu's Tracker over frames 1-12: per-frame records, trajectory,
    its state as numpy after them, and the tracker (stepped once more by
    (c))."""
    T_wc, grays, depths = frames
    tr = JaxTracker(_jax_cfg(), use_local_ba=False, use_loop_closing=False)
    recs = []
    for i in range(START, END):
        res = tr.track_rgbd(grays[i], depths[i], T_cw_init=np.linalg.inv(T_wc[START]))
        recs.append(_record(tr, res))
    return recs, tr.get_trajectory(), convert.tracker_state_numpy(tr), tr


@pytest.fixture(scope="module")
def port_run(frames):
    """The port over frames 1-12 through VOSystem.track_rgbd."""
    T_wc, grays, depths = frames
    system = VOSystem(_port_cfg(), "cpu", use_local_ba=False, use_loop_closing=False)
    system.tracker.T_cw = np.linalg.inv(T_wc[START]).astype(np.float32)
    recs = []
    for i in range(START, END):
        res = system.track_rgbd(grays[i], depths[i], i / 30.0)
        recs.append(_record(system.tracker, res))
    return recs, system.get_trajectory()


def _pose_gap(Ta, Tb):
    """(metres, degrees) between two poses; the angle from the skew part of
    the relative rotation (float64), exact where the trace form is not."""
    D = Ta.astype(np.float64) @ np.linalg.inv(Tb.astype(np.float64))
    R = D[:3, :3]
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]), np.degrees(np.arctan2(s, 0.5 * (np.trace(R) - 1)))


def test_a_per_frame_parity_with_jax(jax_run, port_run):
    j, p = jax_run[0], port_run[0]
    assert [r["kf"] for r in p] == [r["kf"] for r in j]
    assert [r["manh"] for r in p] == [r["manh"] for r in j]
    assert all(r["state"] == "OK" for r in p + j)
    for i, (a, b) in enumerate(zip(j, p)):
        dt, dr = _pose_gap(b["T"], a["T"])
        assert dt < 2e-3 and dr < 0.1, f"frame {i + START}: {dt * 1e3:.3f} mm, {dr:.4f} deg"
        if a["manh"]:
            assert same_frame(b["R_wm"], a["R_wm"], 1e-5), f"frame {i + START}"
        np.testing.assert_array_equal(b["pvalid"], a["pvalid"], err_msg=f"frame {i + START}")
        v = a["pvalid"]
        np.testing.assert_array_equal(b["kind"][v], a["kind"][v], err_msg=f"frame {i + START}")
        np.testing.assert_array_equal(b["map_idx"][v], a["map_idx"][v], err_msg=f"frame {i + START}")
    # What the orbit drives: the Manhattan frame from the first frame, the
    # plane edges, and up to 3 segmented planes.
    assert j[0]["manh"] and sum(r["pvalid"].sum() for r in j[-1:]) == 3
    assert sum(int((r["kind"][r["pvalid"]] == 0).sum()) for r in j[1:]) >= len(j) - 1


def test_b_ate_within_jax(frames, jax_run, port_run):
    T_wc = frames[0][START:END]
    ts = np.arange(END - START) / 30.0
    ate_j = evaluate.ate(ts, T_wc, ts, jax_run[1], align="origin").rmse
    ate_p = evaluate.ate(ts, T_wc, ts, port_run[1], align="origin").rmse
    assert ate_p <= 1.5 * ate_j, (ate_p, ate_j)


def test_c_step_from_carried_state(frames, jax_run):
    _, grays, depths = frames
    _, _, state, jt = jax_run
    assert state["last_plane_out"] is not None and state["manhattan"]["manh_valid"]
    pt = Tracker(_port_cfg(), "cpu", use_local_ba=False, use_loop_closing=False)
    convert.tracker_state_from_numpy(pt, state)
    back = convert.tracker_state_numpy(pt)
    for key in ("R_wm", "manh_valid", "manh_fine_done", "manh_fine_pending"):
        np.testing.assert_array_equal(back["manhattan"][key], state["manhattan"][key])
    for key, val in state["last_plane_out"]["seg"].items():
        np.testing.assert_array_equal(back["last_plane_out"]["seg"][key], val)
    want = jt.track_rgbd(grays[END], depths[END])
    got = pt.track_rgbd(grays[END], depths[END])
    assert got.state is TrackState.OK and want.state.name == "OK"
    np.testing.assert_allclose(got.T_cw, want.T_cw, atol=5e-4, rtol=0)
    assert got.n_matches == want.n_matches
    jo, po = jt._last_plane_out, pt._last_plane_out
    np.testing.assert_array_equal(po.kind, np.asarray(jo[2]))
    np.testing.assert_array_equal(po.map_idx, np.asarray(jo[1]))
    np.testing.assert_array_equal(po.inlier, np.asarray(jo[3]))
    np.testing.assert_allclose(pt._last_axes[0], np.asarray(jt._last_axes[0]), atol=1e-5, rtol=0)


def _keyframe_pair(frames, state):
    """A JAX and a port tracker holding the same state (the JAX state after
    frame 12: map, pose, Manhattan frame, last line and plane results), and
    the host features of frame 13 and their BoW words. The JAX tracker is
    filled by hand, so nothing of it compiles."""
    _, grays, depths = frames
    pt = Tracker(_port_cfg(), "cpu", use_local_ba=False, use_loop_closing=False)
    convert.tracker_state_from_numpy(pt, state)
    pt._prev_line_feed = None
    jt = JaxTracker(_jax_cfg(), use_local_ba=False, use_loop_closing=False)
    vm = jt.vomap
    for name, fields in state["tables"].items():
        for key, value in fields.items():
            setattr(getattr(vm, name), key, np.array(value))
    for k, v in state["map_scalars"].items():
        setattr(vm, k, int(v))
    vm.free_kf_slots = list(state["free_kf_slots"])
    jt.kf_db.hists = np.array(state["kf_db_hists"])
    jt.kf_db.valid = np.array(state["kf_db_valid"])
    for k in ("frame_id", "last_kf_frame", "n_matches_ref_kf", "manh_valid", "_manh_fine_done",
              "_manh_fine_pending", "_last_line_out", "_last_plane_out", "_last_axes"):
        setattr(jt, k, getattr(pt, k))
    for k in ("T_cw", "velocity", "R_wm"):
        setattr(jt, k, getattr(pt, k).copy())
    jt.mapper.R_wm, jt.mapper.manh_valid = pt.mapper.R_wm, pt.mapper.manh_valid
    feats = _feats_to_host(extract_frame(t(grays[END]), t(depths[END]), _port_cfg()))
    words = compute_words(t(feats.desc.astype(np.int64))).numpy()
    return jt, pt, feats, words


def _insert_keyframe(trackers, feats, words):
    for tr in trackers:
        tr.frame_id += 1
        tr._last_words = (tr.frame_id, words)
        tr._create_keyframe(feats, np.full(len(feats.valid), -1, np.int32))


def _assert_same_tables(jt, pt, names):
    for name in names:
        a, b = getattr(jt.vomap, name), getattr(pt.vomap, name)
        for f in dataclasses.fields(a):
            x, y = getattr(b, f.name), getattr(a, f.name)
            if np.issubdtype(y.dtype, np.floating):
                np.testing.assert_allclose(x, y, atol=1e-6, rtol=0, err_msg=f"{name}.{f.name}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{name}.{f.name}")


def test_d_new_map_planes_and_merge(frames, jax_run):
    """At a keyframe two observed planes without a match or constraint
    become map planes, and a third 2 cm off the first merges into it."""
    state = jax_run[2]
    jt, pt, feats, words = _keyframe_pair(frames, state)
    seg, map_idx, kind, inlier = pt._last_plane_out
    v = np.nonzero(seg.valid)[0]
    assert len(v) == 3 and len(seg.valid) > 3
    seg = seg._replace(planes=seg.planes.copy(), centroids=seg.centroids.copy(),
                       counts=seg.counts.copy(), valid=seg.valid.copy(), covs=seg.covs.copy())
    kind, map_idx = kind.copy(), map_idx.copy()
    kind[v[1:]], map_idx[v[1:]] = -1, -1
    seg.planes[3] = seg.planes[v[1]] + np.array([0, 0, 0, 0.02], np.float32)
    seg.centroids[3] = seg.centroids[v[1]] - 0.02 * seg.planes[v[1], :3]
    seg.counts[3], seg.covs[3], seg.valid[3] = 5000.0, seg.covs[v[1]], True
    kind[3], map_idx[3] = -1, -1
    crafted = type(pt._last_plane_out)(seg, map_idx, kind, inlier)
    jt._last_plane_out = pt._last_plane_out = crafted
    before = int(pt.vomap.planes.valid.sum())
    _insert_keyframe((jt, pt), feats, words)
    assert int(pt.vomap.planes.valid.sum()) == before + 2
    _assert_same_tables(jt, pt, ("planes", "kf_planes", "points", "lines", "keyframes"))


def test_e_fine_manhattan_init_applies_at_the_next_keyframe(frames, jax_run):
    state = jax_run[2]
    assert state["map_scalars"]["next_kf_slot"] - len(state["free_kf_slots"]) == 3
    jt, pt, feats, words = _keyframe_pair(frames, state)
    lt = pt.vomap.lines
    assert (lt.valid & (lt.manh_idx >= 0)).sum() >= 12
    R0 = pt.R_wm.copy()
    _insert_keyframe((jt, pt), feats, words)  # the 4th keyframe: dispatched
    assert pt.vomap.n_keyframes() == 4 and pt._manh_fine_pending is not None
    np.testing.assert_array_equal(pt.R_wm, R0)
    np.testing.assert_array_equal(jt.R_wm, R0)
    assert not pt._manh_fine_done and not jt._manh_fine_done
    pending = pt._manh_fine_pending.copy()
    np.testing.assert_allclose(pending, np.asarray(jt._manh_fine_pending), atol=1e-5, rtol=0)
    assert np.abs(pending - R0).max() > 1e-6  # it moves the frame
    _insert_keyframe((jt, pt), feats, words)  # the 5th: applied
    assert pt._manh_fine_done and jt._manh_fine_done and pt._manh_fine_pending is None
    np.testing.assert_array_equal(pt.R_wm, pending)
    np.testing.assert_allclose(pt.R_wm, jt.R_wm, atol=1e-5, rtol=0)
    _assert_same_tables(jt, pt, ("lines", "planes", "kf_planes"))


def test_full_step_config_and_entry_points():
    """full_step keeps the preset's three feature flags and turns off only
    the triangulations; Tracker and VOSystem take it, BatchTracker refuses
    it until its slice."""
    cfg = _port_cfg()
    assert cfg.use_lines and cfg.use_planes and cfg.use_manhattan
    assert not (cfg.tracking.triangulate_new_points or cfg.tracking.triangulate_new_lines)
    base = tum3_config()
    assert dataclasses.replace(cfg, tracking=base.tracking) == base
    assert full_step(points_and_lines(base)) == points_and_lines(base)
    VOSystem(cfg, "cpu", use_local_ba=False, use_loop_closing=False)
    with pytest.raises(NotImplementedError, match="next slice"):
        BatchTracker(cfg, n_seq=2, device="cpu", use_local_ba=False)


def test_cpu_run_does_not_launch_the_kernels(port_run):
    assert fast.fast_dual_launches == 0 and lines.hough_vote_launches == 0
    assert fast.fast_dual_batched_launches == 0 and lines.hough_vote_batched_launches == 0
