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
(f) The keyframe path from one state: the JAX state after frame 12 (3
    keyframes) loaded into a JAX and a port tracker with triangulation and
    local BA on (`tum3_config()`, the JAX package's default system without
    loop closing). A seeded third of the keyframes' point observations and
    line observations is removed from the state and a third of the new
    keyframe's keypoints lose their depth and segments their 3D fit, so
    that both triangulations have candidates. The 4th keyframe is inserted
    and the keyframe path runs on both in the JAX package's order
    (triangulate points, lines, fuse, re-elect, local BA). Compared: the
    points and lines created (counts within 2 %, positions within 1 mm),
    the BA problem (window, gauge, edge tables equal, its other inputs
    within 1e-4), the final BA cost (1 %), the keyframe poses after BA
    (5 mm, 0.1 deg: an accept decision between two nearly equal costs
    flips late in the LM, see the test), the same inlier edges, and the
    observations BA erased (differing in at most 0.5 % of its edges).
(g) Relocalization and the metric 3D step from the carried state.
(h) The facade's state paths from the carried state: the JAX package
    writes a checkpoint of it; the port's `load_checkpoint` and a fresh JAX
    tracker's each load it (no line feed: both take the branch of a tracker
    with no previous frame) and track frame 13: poses within 5e-4, equal
    matches (as (c)); the port's `save_checkpoint` writes the same keys and
    arrays, and the JAX package loads it. Then `track_rgbd_async` at depth
    1 over frames 13-15 and `flush` on both packages from the carried state,
    and at depth 3 with resolve_burst 2 over frames 13-16 (resolve-first, a
    prediction chained on two in-flight poses, a group of 2 resolved by one
    call, the last group by `flush`): the same frames returned by the same
    calls, the same states, and poses within 2 mm and 0.1 deg.
The JAX tracker runs once for all xdist workers, in one module fixture: its
full step compiles for about 65 s. The JAX trackers of (d) to (h) compile
their programs again in their own worker, from JAX's persistent compilation
cache where this or another worker has compiled them (torch_helpers.
pytest_collection_finish). (f) adds no JAX tracker run: it compiles only
the JAX package's triangulations and its local BA.
"""
import copy
import dataclasses

import numpy as np
import pytest

import hfvo_tpu.mapping.local_mapping as jax_local_mapping
import hfvo_tpu.vomap.checkpoint as jax_checkpoint
import hfvo_tpu_torch.vomap.checkpoint as port_checkpoint
from hfvo_tpu.config import tum3_config as jax_tum3
import hfvo_tpu.tracking.matcher as jax_matcher
import hfvo_tpu_torch.tracking.matcher as port_matcher
from hfvo_tpu.tracking.tracker import Tracker as JaxTracker
from hfvo_tpu.tracking.tracker import TrackState as JaxTrackState
import hfvo_tpu_torch.mapping.local_mapping as port_local_mapping
from hfvo_tpu_torch import convert
from hfvo_tpu_torch.bow.vocab import compute_words
from hfvo_tpu_torch.config import full_step, points_and_lines, tum3_config
from hfvo_tpu_torch.io import evaluate
from hfvo_tpu_torch.ops import fast, lines
from hfvo_tpu_torch.parallel.multiseq import BatchTracker
from hfvo_tpu_torch.system import VOSystem
from hfvo_tpu_torch.testing import synthetic as tsyn
from hfvo_tpu_torch.tracking.frontend import extract_frame
from hfvo_tpu_torch.tracking.tracker import Tracker, TrackState, _feats_to_host, _gray_u8
from hfvo_tpu_torch.solve import pnp as port_pnp
from hfvo_tpu_torch.solve import ransac as port_ransac
from test_torch_reloc import jax_draw
from torch_helpers import same_frame, shared_result, shared_results, t

START, END = 1, 13  # frames 1..12
N_FRAMES = END + 4  # frame 13 for the carried step, 14-16 for the pipelined ones


def _jax_cfg():
    c = jax_tum3()
    return c.replace(tracking=dataclasses.replace(
        c.tracking, triangulate_new_points=False, triangulate_new_lines=False))


def _port_cfg():
    return full_step(tum3_config())


# The module fixtures are computed once for all xdist workers
# (torch_helpers.shared_result, shared_results). A worker that takes
# `jax_run`'s records from another compiles the JAX programs of tests (d)
# to (h) inside them, and JAX's persistent cache, which the worker that ran
# `jax_run` filled, turns those compiles into loads
# (torch_helpers.pytest_collection_finish).


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return shared_result(tmp_path_factory, "full_tracker_frames", lambda: tsyn.render_sequence(n=N_FRAMES, seed=0))


def _record(tracker, res):
    po = tracker._last_plane_out
    return dict(
        T=np.asarray(res.T_cw), kf=bool(res.is_keyframe), state=res.state.name,
        n=int(res.n_matches), manh=bool(tracker.manh_valid), R_wm=np.array(tracker.R_wm),
        pvalid=np.array(po[0].valid), kind=np.array(po[2]), map_idx=np.array(po[1]),
    )


def _launches():
    return (fast.fast_dual_launches, lines.hough_vote_launches, fast.fast_dual_batched_launches,
            lines.hough_vote_batched_launches)


def _jax_run(frames):
    """hfvo_tpu's Tracker over frames 1-12: per-frame records, trajectory,
    its state as numpy after them, and its step on frame 13 from that state
    (for (c)): the result's state name, T_cw and matches, its plane
    association (kind, map row, inlier) and measured axes."""
    T_wc, grays, depths = frames
    tr = JaxTracker(_jax_cfg(), use_local_ba=False, use_loop_closing=False)
    recs = []
    for i in range(START, END):
        res = tr.track_rgbd(grays[i], depths[i], T_cw_init=np.linalg.inv(T_wc[START]))
        recs.append(_record(tr, res))
    state = copy.deepcopy(convert.tracker_state_numpy(tr))
    want = tr.track_rgbd(grays[END], depths[END])
    po = tr._last_plane_out
    step = dict(state=want.state.name, T=np.asarray(want.T_cw), n=int(want.n_matches),
                kind=np.asarray(po[2]), map_idx=np.asarray(po[1]), inlier=np.asarray(po[3]),
                axes=np.asarray(tr._last_axes[0]))
    return recs, tr.get_trajectory(), state, step


def _port_run(frames):
    """The port over frames 1-12 through VOSystem.track_rgbd: records,
    trajectory, and the kernel launches of the run (K1, K3, K1b, K3b)."""
    T_wc, grays, depths = frames
    launches0 = _launches()
    system = VOSystem(_port_cfg(), "cpu", use_local_ba=False, use_loop_closing=False)
    system.tracker.T_cw = np.linalg.inv(T_wc[START]).astype(np.float32)
    recs = []
    for i in range(START, END):
        res = system.track_rgbd(grays[i], depths[i], i / 30.0)
        recs.append(_record(system.tracker, res))
    return recs, system.get_trajectory(), tuple(b - a for a, b in zip(launches0, _launches()))


@pytest.fixture(scope="module")
def runs(frames, tmp_path_factory):
    return shared_results(tmp_path_factory, {"full_tracker_jax_run": lambda: _jax_run(frames),
                                             "full_tracker_port_run": lambda: _port_run(frames)})


@pytest.fixture(scope="module")
def jax_run(runs):
    return runs["full_tracker_jax_run"]


@pytest.fixture(scope="module")
def port_run(runs):
    return runs["full_tracker_port_run"]


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
    _, _, state, want = jax_run
    assert state["last_plane_out"] is not None and state["manhattan"]["manh_valid"]
    pt = Tracker(_port_cfg(), "cpu", use_local_ba=False, use_loop_closing=False)
    convert.tracker_state_from_numpy(pt, state)
    back = convert.tracker_state_numpy(pt)
    for key in ("R_wm", "manh_valid", "manh_fine_done", "manh_fine_pending"):
        np.testing.assert_array_equal(back["manhattan"][key], state["manhattan"][key])
    for key, val in state["last_plane_out"]["seg"].items():
        np.testing.assert_array_equal(back["last_plane_out"]["seg"][key], val)
    got = pt.track_rgbd(grays[END], depths[END])
    assert got.state is TrackState.OK and want["state"] == "OK"
    np.testing.assert_allclose(got.T_cw, want["T"], atol=5e-4, rtol=0)
    assert got.n_matches == want["n"]
    po = pt._last_plane_out
    np.testing.assert_array_equal(po.kind, want["kind"])
    np.testing.assert_array_equal(po.map_idx, want["map_idx"])
    np.testing.assert_array_equal(po.inlier, want["inlier"])
    np.testing.assert_allclose(pt._last_axes[0], want["axes"], atol=1e-5, rtol=0)


def _keyframe_pair(frames, state, jax_cfg=None, port_cfg=None, use_local_ba=False, keep_feed=False):
    """A JAX and a port tracker holding the same state (the JAX state after
    frame 12: map, pose, Manhattan frame, last line and plane results), and
    the host features of frame 13 and their BoW words. The JAX tracker is
    filled by hand, so nothing of it compiles. With `keep_feed` both keep
    the previous frame's line feed and tracking state, so both can track."""
    _, grays, depths = frames
    port_cfg = port_cfg or _port_cfg()
    pt = Tracker(port_cfg, "cpu", use_local_ba=use_local_ba, use_loop_closing=False)
    convert.tracker_state_from_numpy(pt, state)
    if not keep_feed:
        pt._prev_line_feed = None
    jt = JaxTracker(jax_cfg or _jax_cfg(), use_local_ba=use_local_ba, use_loop_closing=False)
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
    if keep_feed:
        jt._prev_line_feed = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
                              for k, v in state["line_feed"].items()}
        jt._last_n_matches = pt._last_n_matches
        jt._traj_rel = list(pt._traj_rel)
        jt.state = JaxTrackState[state["state"]]
    feats = _feats_to_host(extract_frame(t(grays[END]), t(depths[END]), port_cfg))
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
    the triangulations; Tracker, VOSystem and BatchTracker take it, and the
    default config (triangulation on) with local BA."""
    cfg = _port_cfg()
    assert cfg.use_lines and cfg.use_planes and cfg.use_manhattan
    assert not (cfg.tracking.triangulate_new_points or cfg.tracking.triangulate_new_lines)
    base = tum3_config()
    assert dataclasses.replace(cfg, tracking=base.tracking) == base
    assert full_step(points_and_lines(base)) == points_and_lines(base)
    VOSystem(cfg, "cpu", use_local_ba=False, use_loop_closing=False)
    VOSystem(base, "cpu", use_local_ba=True, use_loop_closing=False)
    bt = BatchTracker(cfg, n_seq=2, device="cpu", use_local_ba=False)
    assert all(tr.cfg.use_planes and tr.cfg.use_manhattan for tr in bt.trackers)


def _thin_state(state, seed=0):
    """A copy of `state` with a seeded third of the keyframes' point and
    line observations removed (their landmarks' n_obs decremented)."""
    rng = np.random.default_rng(seed)
    st = dict(state, tables={k: {f: np.array(v) for f, v in d.items()} for k, d in state["tables"].items()})
    for kft, ident, lmt in (("keyframes", "point_id", "points"), ("kf_lines", "line_id", "lines")):
        tab = st["tables"][kft]
        drop = tab["obs_valid"] & (tab[ident] >= 0) & (rng.uniform(size=tab[ident].shape) < 1 / 3)
        np.add.at(st["tables"][lmt]["n_obs"], tab[ident][drop], -1)
        tab[ident][drop] = -1
        tab["obs_valid"][drop] = False
    return st


def _capturing(fn, store):
    """`fn` (a local BA) that appends each call's (problem, result) to
    `store`."""
    def wrapped(prob, *a, **kw):
        res = fn(prob, *a, **kw)
        store.append((prob, res))
        return res

    return wrapped


def _np(x):
    return x.numpy() if hasattr(x, "numpy") and not isinstance(x, np.ndarray) else np.asarray(x)


def test_f_keyframe_path_from_carried_state(frames, jax_run, monkeypatch):
    _, grays, depths = frames
    state = _thin_state(jax_run[2])
    jt, pt, _, _ = _keyframe_pair(frames, state, jax_cfg=jax_tum3(), port_cfg=tum3_config(), use_local_ba=True)
    # Frame 13's step, by a third port tracker on the same state: the new
    # keyframe's features, matches, pose and line and plane results.
    st = Tracker(tum3_config(), "cpu", use_local_ba=False, use_loop_closing=False)
    convert.tracker_state_from_numpy(st, state)
    st.frame_id += 1
    ok, T_new, pt_per_kp, _, feats = st._track_local_map(
        st._upload(_gray_u8(np.asarray(grays[END]))[None]),
        st._upload(st._depth_host_u16(np.asarray(depths[END])).astype(np.int32)[None]),
        st.velocity @ st.T_cw)
    assert ok
    rng = np.random.default_rng(1)
    feats = feats._replace(depth=np.where((pt_per_kp < 0) & (rng.uniform(size=feats.depth.shape) < 1 / 3),
                                          0.0, feats.depth).astype(np.float32))
    lf, l3d, ln = st._last_line_out
    l3d = l3d._replace(valid=np.asarray(l3d.valid) & (rng.uniform(size=len(l3d.valid)) >= 1 / 3))
    for tr in (jt, pt):
        tr._last_line_out, tr._last_plane_out, tr._last_axes = (lf, l3d, ln), st._last_plane_out, st._last_axes
        tr.T_cw = T_new.copy()
        tr.frame_id += 1
        tr._last_words = (tr.frame_id, st._last_words[1])
        tr._create_keyframe(feats, pt_per_kp)
    assert pt.vomap.n_keyframes() == 4 and jt.vomap.n_keyframes() == 4
    _assert_same_tables(jt, pt, ("points", "lines", "keyframes", "kf_lines"))

    made = {}
    for name, tr in (("jax", jt), ("port", pt)):
        n_pts0, n_lines0 = int(tr.vomap.points.valid.sum()), int(tr.vomap.lines.valid.sum())
        made[name] = (tr.mapper.create_new_map_points(), tr.mapper.create_new_map_lines())
        assert int(tr.vomap.points.valid.sum()) == n_pts0 + made[name][0]
        assert int(tr.vomap.lines.valid.sum()) == n_lines0 + made[name][1]
    (pj, lj), (pp, lp) = made["jax"], made["port"]
    assert pj >= 20 and lj >= 1, made  # both triangulations create landmarks
    assert abs(pp - pj) <= 0.02 * pj and abs(lp - lj) <= 0.02 * lj, made
    for tab in ("points", "lines"):
        a, b = getattr(jt.vomap, tab), getattr(pt.vomap, tab)
        both = a.valid & b.valid
        np.testing.assert_array_equal(a.valid, b.valid, err_msg=tab)
        for f in (("X_w",) if tab == "points" else ("X0_w", "X1_w")):
            assert np.abs(getattr(a, f)[both] - getattr(b, f)[both]).max() < 1e-3, (tab, f)
    _assert_same_tables(jt, pt, ("keyframes", "kf_lines"))

    for tr in (jt, pt):
        tr.mapper.fuse_points()
        tr.mapper.fuse_lines()
        tr.mapper.reelect_point_descriptors()
    probs = {"jax": [], "port": []}
    for mod, key in ((jax_local_mapping, "jax"), (port_local_mapping, "port")):
        monkeypatch.setattr(mod, "local_bundle_adjustment", _capturing(mod.local_bundle_adjustment, probs[key]))
    edges0 = jt.vomap.keyframes.obs_valid.copy()
    assert jt.mapper.run_local_ba() and pt.mapper.run_local_ba()
    assert jt.mapper.n_ba_runs == pt.mapper.n_ba_runs == 1
    ((qj, rj),), ((qp, rp),) = probs["jax"], probs["port"]
    for f in ("kf_free", "e_kf", "e_pt", "e_valid", "e_stereo", "le_kf", "le_lm", "le_valid",
              "lp_s", "lp_e", "lp_valid", "ll_sa", "ll_ea", "ll_kind", "ll_valid"):
        a, b = getattr(qj, f), getattr(qp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(_np(b), _np(a), err_msg=f)
    np.testing.assert_array_equal(_np(qp.kf_T_cw), _np(qj.kf_T_cw))
    for f in ("pt_X", "e_obs", "e_inv_sigma2", "le_line2d", "lp_axis", "lp_w", "ll_w",
              "kf_axes_c", "kf_axes_w", "kf_w_axis"):
        np.testing.assert_allclose(_np(getattr(qp, f)), _np(getattr(qj, f)), atol=1e-4, rtol=0, err_msg=f)
    n_edges = int(_np(qj.e_valid).sum())
    assert n_edges > 500 and int(_np(qj.kf_free).sum()) >= 2

    # The LM accepts a step where its cost falls; where two costs are nearly
    # equal, float32 rounding decides, and one flipped decision sends the
    # two solvers down different paths. On this state that happens late in
    # the second stage, and the keyframe poses part by a few mm (the window
    # is ill-conditioned: the line endpoints slide by up to metres along
    # their lines). So the final costs are held to 1 %, and the poses to
    # 5 mm and 0.1 deg instead of 0.5 mm and 0.05 deg.
    cj, cp = float(_np(rj.chi2)), float(_np(rp.chi2))
    assert abs(cp - cj) <= 0.01 * cj, (cp, cj)
    kj, kp = jt.vomap.keyframes, pt.vomap.keyframes
    for k in np.nonzero(kj.valid)[0]:
        dt, dr = _pose_gap(kp.T_cw[k], kj.T_cw[k])
        assert dt < 5e-3 and dr < 0.1, (k, dt * 1e3, dr)
    moved = max(np.abs(kj.T_cw[k] - state["tables"]["keyframes"]["T_cw"][k]).max()
                for k in np.nonzero(kj.valid)[0][:3])
    assert moved > 0  # BA moved the window
    np.testing.assert_array_equal(_np(rp.e_inlier), _np(rj.e_inlier))
    erased_j = edges0 & ~kj.obs_valid
    erased_p = edges0 & ~kp.obs_valid
    assert (erased_j != erased_p).sum() <= 0.005 * n_edges, (erased_j.sum(), erased_p.sum())


def test_cpu_run_does_not_launch_the_kernels(port_run):
    assert port_run[2] == (0, 0, 0, 0)


def _recording(fn, store):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        store.append(tuple(np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in out))
        return out

    return wrapped


def test_g_relocalization_from_carried_state(frames, jax_run, monkeypatch):
    """Both trackers hold the JAX state after frame 12, are put LOST and
    track frame 1 (a kidnap back to the orbit's start), the port's RANSAC
    fed the JAX package's draw. They must retrieve the same BoW candidates,
    make the same mutual matches, take the same branch and end OK with poses
    within 2 mm and 0.1 deg (and within 3 cm of the truth)."""
    T_wc, grays, depths = frames
    jt, pt, _, _ = _keyframe_pair(frames, jax_run[2], keep_feed=True)
    monkeypatch.setattr(port_ransac, "draw_samples", jax_draw)
    monkeypatch.setattr(port_pnp, "draw_samples", jax_draw)
    matches = {"jax": [], "port": []}
    monkeypatch.setattr(jax_matcher, "match_descriptors_mutual",
                        _recording(jax_matcher.match_descriptors_mutual, matches["jax"]))
    monkeypatch.setattr(port_matcher, "match_descriptors_mutual",
                        _recording(port_matcher.match_descriptors_mutual, matches["port"]))
    cands = {"jax": [], "port": []}
    for key, tr in (("jax", jt), ("port", pt)):
        tr.kf_db.query = _recording(tr.kf_db.query, cands[key])
    jt.state, pt.state = JaxTrackState.LOST, TrackState.LOST
    want = jt.track_rgbd(grays[1], depths[1])
    got = pt.track_rgbd(grays[1], depths[1])
    assert want.state.name == "OK" and got.state is TrackState.OK
    assert len(cands["port"]) == len(cands["jax"]) == 1
    np.testing.assert_array_equal(cands["port"][0][0], cands["jax"][0][0])
    assert len(cands["port"][0][0]) >= 1
    assert len(matches["port"]) == len(matches["jax"]) >= 1
    for (ib_p, ok_p), (ib_j, ok_j) in zip(matches["port"], matches["jax"]):
        np.testing.assert_array_equal(ok_p, ok_j)
        np.testing.assert_array_equal(ib_p[ok_j], ib_j[ok_j])
    assert pt.last_reloc is not None and pt.last_reloc[0] == "3d3d"
    dt, dr = _pose_gap(got.T_cw, np.asarray(want.T_cw))
    assert dt < 2e-3 and dr < 0.1, (dt, dr)
    assert np.abs(got.T_cw[:3, 3] - np.linalg.inv(T_wc[1])[:3, 3]).max() < 0.03


def test_g_metric_3d_step_from_carried_state(frames, jax_run, monkeypatch):
    """One step of the fused step with the metric 3D point term
    (`tracking.inv_sigma2_3d = 400`: a seeded 3D-3D RANSAC picks the LM's
    start and the 3D edges' inliers) from the JAX state after frame 12, the
    port's RANSAC fed the JAX package's draw of seed 7: pose within 5e-4 and
    the same point matches, as test_c."""
    _, grays, depths = frames

    def with_3d(cfg):
        return cfg.replace(tracking=dataclasses.replace(cfg.tracking, inv_sigma2_3d=400.0))

    jt, pt, _, _ = _keyframe_pair(frames, jax_run[2], jax_cfg=with_3d(_jax_cfg()),
                                  port_cfg=with_3d(_port_cfg()), keep_feed=True)
    monkeypatch.setattr(port_ransac, "draw_samples", jax_draw)
    want = jt.track_rgbd(grays[END], depths[END])
    got = pt.track_rgbd(grays[END], depths[END])
    assert want.state.name == "OK" and got.state is TrackState.OK
    np.testing.assert_allclose(got.T_cw, np.asarray(want.T_cw), atol=5e-4, rtol=0)
    assert got.n_matches == want.n_matches


def test_h_checkpoint_between_packages(frames, jax_run, tmp_path):
    _, grays, depths = frames
    jsrc, psrc, _, _ = _keyframe_pair(frames, jax_run[2])
    pj, pp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_checkpoint.save_checkpoint(pj, jsrc)
    port_checkpoint.save_checkpoint(pp, psrc)
    a, b = np.load(pj), np.load(pp)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert b[k].dtype == a[k].dtype, k
    pt = Tracker(_port_cfg(), "cpu", use_local_ba=False, use_loop_closing=False)
    port_checkpoint.load_checkpoint(pj, pt)
    assert pt._prev_line_feed is None and pt.state is TrackState.OK
    jt = JaxTracker(_jax_cfg(), use_local_ba=False, use_loop_closing=False)
    jax_checkpoint.load_checkpoint(pj, jt)
    jt2 = JaxTracker(_jax_cfg(), use_local_ba=False, use_loop_closing=False)
    jax_checkpoint.load_checkpoint(pp, jt2)  # the port's file in the JAX package
    _assert_same_tables(jt2, pt, ("points", "lines", "planes", "keyframes", "kf_lines", "kf_planes"))
    want = jt.track_rgbd(grays[END], depths[END])
    got = pt.track_rgbd(grays[END], depths[END])
    assert want.state.name == "OK" and got.state is TrackState.OK
    np.testing.assert_allclose(got.T_cw, np.asarray(want.T_cw), atol=5e-4, rtol=0)
    assert got.n_matches == want.n_matches


def _run_pipelined(jt, pt, grays, depths, frame_ids):
    """Both trackers through track_rgbd_async over `frame_ids`, then flush;
    per call, the results of each."""
    calls = {"jax": [], "port": []}
    for i in frame_ids:
        calls["jax"].append(jt.track_rgbd_async(grays[i], depths[i]))
        calls["port"].append(pt.track_rgbd_async(grays[i], depths[i]))
    calls["jax"].append(jt.flush())
    calls["port"].append(pt.flush())
    return calls


def _assert_same_calls(calls, counts):
    assert [len(c) for c in calls["port"]] == [len(c) for c in calls["jax"]] == counts
    for cj, cp in zip(calls["jax"], calls["port"]):
        for a, b in zip(cj, cp):
            assert b.state.name == a.state.name == "OK"
            assert b.is_keyframe == a.is_keyframe
            dt, dr = _pose_gap(b.T_cw, np.asarray(a.T_cw))
            assert dt < 2e-3 and dr < 0.1, (dt * 1e3, dr)


def test_h_pipelined_tracking_from_carried_state(frames, jax_run):
    _, grays, depths = frames
    jt, pt, _, _ = _keyframe_pair(frames, jax_run[2], keep_feed=True)
    calls = _run_pipelined(jt, pt, grays, depths, range(END, END + 3))
    _assert_same_calls(calls, [0, 1, 1, 1])
    assert set(pt.step_times) == {"upload", "dispatch", "resolve"}
    assert len(pt.step_times["dispatch"]) == 3 and not pt._pipe
    # Depth 3, groups of 2: frames 13 and 14 form a group, resolved first
    # by the call of frame 16; frame 15 is dispatched against a prediction
    # chained on the in-flight poses of 13 and 14; flush resolves the group
    # of 15 and 16.
    jt, pt, _, _ = _keyframe_pair(frames, jax_run[2], keep_feed=True)
    for tr in (jt, pt):
        tr.pipeline_depth, tr.resolve_burst = 3, 2
    calls = _run_pipelined(jt, pt, grays, depths, range(END, END + 4))
    _assert_same_calls(calls, [0, 0, 0, 2, 2])
    assert not pt._pipe and not pt._groups
