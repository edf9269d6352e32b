"""Loop closing's solvers and the loop closer against hfvo_tpu's.

(a) The pose graph's per-edge (6, 12) Jacobian (`torch.func.vmap(jacfwd)`
    over the port's se3, `jax.vmap(jax.jacfwd)` there) on near-identity
    and far-from-identity edges: within 1e-5 of the largest entry.
(b) `optimize_pose_graph` on tests/test_pose_graph.py's consistent chain
    and drifted 12-chain: poses within 1e-4 of the JAX package's, and the
    JAX test's gates (the chain stays; the far-end drift falls below 0.35x).
(c) `global_bundle_adjustment` on tests/test_global_ba.py's seeded
    problems: keyframe poses and landmarks within 1e-4 of the JAX
    package's and the final cost within 1e-4 relative. Every case meets
    1e-4 (no LM accept flips on these problems); the 5 mm / 1 % rule of
    test_torch_full_tracker.py::test_f_* was not needed.
(d) The synthetic loop map (`hfvo_tpu_torch.testing.loop_map`) built into
    both packages' tables: `build_global_ba_problem` gives the same
    problem (the JAX package's padding aside); `LoopCloser.detect_and_close`
    run twice on each (the consistency gate), the port's RANSAC fed the JAX
    package's draw: the same decisions, the pose graph's keyframe poses
    within 1e-4 (the port solves the graph at its own size, the JAX
    package at its padded capacity), the corrected points, line
    endpoints, planes and plane moments within 1e-4 (moments 1e-3
    relative), the same points fused and planes merged (7 points, the
    floor's copy), and after the global BA the keyframe poses within 1e-4,
    the landmarks (4 m away) within 5e-4 m and the cost within 1e-4
    relative: no LM accept flips on this map, so the 5 mm / 1 % rule was
    not needed. The far-end drift falls below 0.35x its value before the
    closure.
(e) Ports of tests/test_loop_landmarks.py: the landmark correction moves
    points, lines, plane coefficients and moments with the keyframe; one
    isolated BoW hit does not pass the consistency gate.
(f) `convert` carries `auto_reset` and the loop closer's state from a JAX
    tracker into the port's.
"""
import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hfvo_tpu.mapping.loop_closing as jlc_mod
import hfvo_tpu_torch.mapping.loop_closing as tlc_mod
from hfvo_tpu.bow.database import KeyFrameDatabase as JaxKeyFrameDatabase
from hfvo_tpu.config import Capacities as JaxCapacities
from hfvo_tpu.config import VOConfig as JaxVOConfig
from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.geometry import se3 as jse3
from hfvo_tpu.mapping.local_mapping import LocalMapper as JaxLocalMapper
from hfvo_tpu.solve import global_ba as jgba
from hfvo_tpu.solve import pose_graph as jpg
from hfvo_tpu.vomap.map import VOMap as JaxVOMap
from hfvo_tpu_torch.bow.database import KeyFrameDatabase
from hfvo_tpu_torch.config import Capacities, VOConfig, tum3_config
from hfvo_tpu_torch.mapping.local_mapping import LocalMapper
from hfvo_tpu_torch.mapping.loop_closing import LoopCloser
from hfvo_tpu_torch.solve import global_ba as tgba
from hfvo_tpu_torch.solve import pose_graph as tpg
from hfvo_tpu_torch.solve import ransac as transac
from hfvo_tpu_torch.testing import loop_map
from hfvo_tpu_torch.vomap.map import VOMap
from test_ba import make_ba_problem, pose_errors
from test_pose_graph import chain_poses
from test_torch_reloc import jax_draw
from torch_helpers import t

JINTR = jax_tum3().camera
TINTR = tum3_config().camera


# ---- (a), (b) the pose graph ---------------------------------------------


@pytest.mark.parametrize("scale", [0.01, 1.0])
def test_edge_jacobian_matches_jax(scale):
    rng = np.random.default_rng(int(scale * 100))
    E = 16

    def rnd(s):
        return np.asarray(jse3.exp_se3(jnp.asarray((rng.normal(size=(E, 6)) * s).astype(np.float32))))

    Ti, Tj, Tij = rnd(3 * scale), rnd(3 * scale), rnd(scale)
    Tinv = np.asarray(jse3.inv(jnp.asarray(Tij)))
    w = rng.uniform(0.5, 2.0, E).astype(np.float32)
    z = np.zeros((E, 12), np.float32)
    args = (z, Ti, Tj, Tinv, w)
    want = np.asarray(jax.jit(jax.vmap(jax.jacfwd(jpg._edge_residual)))(*map(jnp.asarray, args)))
    got = tpg._edge_jacobians(*map(t, args)).numpy()
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    r_j = np.asarray(jax.jit(jax.vmap(jpg._edge_residual))(*map(jnp.asarray, args)))
    np.testing.assert_allclose(tpg._edge_residuals(*map(t, args)).numpy(), r_j, atol=1e-5, rtol=0)


def _drifted_chain():
    """tests/test_pose_graph.py::test_pgo_distributes_loop_drift's graph."""
    n = 12
    T_gt = chain_poses(n, np.array([0.2, 0, 0, 0, 0.05, 0], np.float32))
    noise = np.asarray(jse3.exp_se3(jnp.asarray(np.array([0.01, 0.004, 0, 0, 0.006, 0], np.float32))))
    T = [T_gt[0]]
    for i in range(1, n):
        T.append((noise @ (T_gt[i] @ np.linalg.inv(T_gt[i - 1])) @ T[-1]).astype(np.float32))
    T = np.stack(T)
    e_i, e_j = list(range(n - 1)) + [0], list(range(1, n)) + [n - 1]
    e_T = [T[i] @ np.linalg.inv(T[j]) for i, j in zip(e_i[:-1], e_j[:-1])] + [T_gt[0] @ np.linalg.inv(T_gt[-1])]
    e_w = [1.0] * (n - 1) + [3.0]
    return T_gt, (T, np.arange(n) > 0, np.array(e_i), np.array(e_j), np.stack(e_T).astype(np.float32),
                  np.array(e_w, np.float32))


def _consistent_chain():
    T = chain_poses(8, np.array([0.1, 0, 0.02, 0, 0.05, 0], np.float32))
    e_i = np.arange(7)
    e_T = np.stack([T[i] @ np.linalg.inv(T[i + 1]) for i in e_i]).astype(np.float32)
    return T, (T, np.arange(8) > 0, e_i, e_i + 1, e_T, np.ones(7, np.float32))


@pytest.mark.parametrize("graph", ["consistent", "drifted"])
def test_pose_graph_matches_jax(graph):
    T_gt, (T0, free, e_i, e_j, e_T, e_w) = _consistent_chain() if graph == "consistent" else _drifted_chain()
    want = np.asarray(jpg.optimize_pose_graph(jpg.PoseGraph(
        jnp.asarray(T0), jnp.asarray(free), jnp.asarray(e_i.astype(np.int32)), jnp.asarray(e_j.astype(np.int32)),
        jnp.asarray(e_T), jnp.asarray(e_w))))
    got = tpg.optimize_pose_graph(tpg.PoseGraph(t(T0), t(free), t(e_i.astype(np.int64)),
                                                t(e_j.astype(np.int64)), t(e_T), t(e_w))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if graph == "consistent":
        np.testing.assert_allclose(got, T0, atol=1e-4)
    else:
        drift0 = np.linalg.norm(T0[-1][:3, 3] - T_gt[-1][:3, 3])
        drift1 = np.linalg.norm(got[-1][:3, 3] - T_gt[-1][:3, 3])
        assert drift0 > 0.05 and drift1 < 0.35 * drift0, (drift0, drift1)


# ---- (c) global BA -------------------------------------------------------


def _to_problems(prob, free_first_two=False):
    """A tests/test_ba.py problem as both packages' GlobalBAProblem."""
    fields = jgba.GlobalBAProblem._fields
    free = np.asarray(prob.kf_free).copy()
    if free_first_two:
        free[1] = True  # one gauge, as tests/test_global_ba.py's many-keyframes case
    arrays = {f: np.asarray(getattr(prob, f)) for f in fields}
    arrays["kf_free"] = free
    jp = jgba.GlobalBAProblem(**{f: jnp.asarray(a) for f, a in arrays.items()})
    tp = tgba.GlobalBAProblem(**{f: t(a.astype(np.int64) if a.dtype == np.int32 else a) for f, a in arrays.items()})
    return jp, tp


_GBA_CASES = {
    # name: (make_ba_problem kwargs, n_iters, cg_iters, one gauge)
    "converges": (dict(K=6, P=300, pose_noise=0.03, pt_noise=0.03, obs_noise=0.3), 12, 40, False),
    "outliers": (dict(K=6, P=300, pose_noise=0.02, pt_noise=0.02, obs_noise=0.3, outlier_frac=0.15), 12, 40, False),
    "many_keyframes": (dict(K=24, P=500, pose_noise=0.015, pt_noise=0.02, obs_noise=0.3), 15, 80, True),
}


@pytest.mark.parametrize("case", sorted(_GBA_CASES))
def test_global_ba_matches_jax(case):
    kw, n_iters, cg_iters, one_gauge = _GBA_CASES[case]
    prob, T_gt, X_gt, _ = make_ba_problem(np.random.default_rng(0), **kw)
    jp, tp = _to_problems(prob, one_gauge)
    want = jgba.global_bundle_adjustment(jp, JINTR, n_iters=n_iters, cg_iters=cg_iters)
    got = tgba.global_bundle_adjustment(tp, TINTR, n_iters=n_iters, cg_iters=cg_iters)
    np.testing.assert_allclose(got.kf_T_cw.numpy(), np.asarray(want.kf_T_cw), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.pt_X.numpy(), np.asarray(want.pt_X), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.e_inlier.numpy(), np.asarray(want.e_inlier))
    assert abs(float(got.chi2) - float(want.chi2)) <= 1e-4 * float(want.chi2)
    # tests/test_global_ba.py's gates: the free poses recover the truth (the
    # many-keyframe case gates the well-observed majority).
    perr = pose_errors(got.kf_T_cw.numpy(), T_gt)[:, :3]
    if case == "many_keyframes":
        assert np.median(perr[1:].max(axis=1)) < 0.005 and perr[1:16].max() < 0.01, perr.max()
    else:
        assert perr[2:].max() < (0.02 if case == "outliers" else 0.01), perr.max()


# ---- (d) the loop closer on the synthetic loop map ---------------------------


def _loop_cfgs():
    """Both packages' tum3 config with smaller map capacities (the loop map
    holds 888 points and 40 lines)."""
    cap = dict(map_points=2048, map_lines=256, map_planes=16, keyframes=32)
    return (jax_tum3().replace(cap=JaxCapacities(**cap)), tum3_config().replace(cap=Capacities(**cap)))


def _loop_maps():
    """The loop map in both packages' tables, with a tracker stand-in each
    (the keyframe database, the local mapper, a snapshot hook)."""
    jcfg, tcfg = _loop_cfgs()
    out = []
    for cfg, VM, DB, LM, extra in ((jcfg, JaxVOMap, JaxKeyFrameDatabase, JaxLocalMapper, ()),
                                   (tcfg, VOMap, KeyFrameDatabase, LocalMapper, ("cpu",))):
        vm, db = VM(cfg), DB(cfg.cap.keyframes)
        gt = loop_map.build_loop_map(vm, db, cfg)
        trk = types.SimpleNamespace(kf_db=db, mapper=LM(cfg, vm, *extra), invalidate_map_snapshot=lambda: None)
        out.append((cfg, vm, trk, gt))
    return out


def _tables_equal(a, b, names, atol=0.0):
    for name in names:
        ta, tb = getattr(a, name), getattr(b, name)
        for f in ta.__dataclass_fields__:
            x, y = np.asarray(getattr(tb, f)), np.asarray(getattr(ta, f))
            if np.issubdtype(y.dtype, np.floating) and atol:
                scale = np.maximum(np.abs(y), 1.0) if f in ("m_outer", "m_sum", "m_w") else 1.0
                assert np.all(np.abs(x - y) <= atol * scale), (name, f, np.abs(x - y).max())
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{name}.{f}")


def test_loop_map_builds_the_same_tables_and_problem():
    (jcfg, jvm, jtrk, jgt), (tcfg, tvm, ttrk, tgt) = _loop_maps()
    _tables_equal(jvm, tvm, ("points", "lines", "planes", "keyframes", "kf_lines"))
    np.testing.assert_array_equal(ttrk.kf_db.hists, jtrk.kf_db.hists)
    jp, jw, ju, jl = jgba.build_global_ba_problem(jvm, gauge_kf=0)
    tp, tw, tu, tl = tgba.build_global_ba_problem(tvm, gauge_kf=0, device="cpu")
    for a, b in ((jw, tw), (ju, tu), (jl, tl)):
        np.testing.assert_array_equal(b, a)
    for f in tgba.GlobalBAProblem._fields:
        got = getattr(tp, f).numpy()
        want = np.asarray(getattr(jp, f))[: len(got)]  # the JAX package pads each table
        np.testing.assert_array_equal(got, want, err_msg=f)
        assert not np.asarray(getattr(jp, f))[len(got):].any() or f in ("kf_T_cw", "le_line2d"), f
    assert len(tw) == loop_map.N_KF and tp.le_kf.shape[0] > 0


def _capture_gba(monkeypatch, mod, store):
    """Wrap `mod.run_global_ba` so each call stores a copy of the map it
    starts from (the corrected, fused map) and its cost."""
    fn = mod.run_global_ba

    def wrapped(vm, *a, **kw):
        store["before"] = copy.deepcopy(vm)
        store["chi2"] = fn(vm, *a, **kw)
        return store["chi2"]

    monkeypatch.setattr(mod, "run_global_ba", wrapped)


def test_loop_closer_matches_jax(monkeypatch):
    (jcfg, jvm, jtrk, gt), (tcfg, tvm, ttrk, _) = _loop_maps()
    # The port's RANSAC draws what the JAX package draws.
    monkeypatch.setattr(transac, "draw_samples", jax_draw)
    jstore, tstore = {}, {}
    _capture_gba(monkeypatch, jgba, jstore)  # imported at its call there
    _capture_gba(monkeypatch, tlc_mod, tstore)
    jlc, tlc = jlc_mod.LoopCloser(jcfg, jvm), LoopCloser(tcfg, tvm, "cpu")
    T_before = tvm.keyframes.T_cw[gt["slots"]].copy()
    n_pts, n_planes = int(tvm.points.valid.sum()), int(tvm.planes.valid.sum())
    assert not jlc.detect_and_close(jtrk) and not tlc.detect_and_close(ttrk)
    assert jlc._consistency_count == tlc._consistency_count == 1
    assert jlc.detect_and_close(jtrk) and tlc.detect_and_close(ttrk)
    assert jlc.n_loops_closed == tlc.n_loops_closed == 1 and jlc.last_loop_order == tlc.last_loop_order

    # The pose graph, the landmark correction, the fuse and the plane merge.
    jb, tb = jstore["before"], tstore["before"]
    _tables_equal(jb, tb, ("points", "lines", "planes"), atol=1e-4)
    np.testing.assert_allclose(tb.keyframes.T_cw, jb.keyframes.T_cw, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tb.keyframes.point_id, jb.keyframes.point_id)
    n_fused = n_pts - int(tb.points.valid.sum())
    assert n_fused == 7 and int(tb.planes.valid.sum()) == n_planes - 1  # the floor's copy merged
    T_pg = tb.keyframes.T_cw[gt["slots"]]
    d0 = np.linalg.norm(T_before[-1][:3, 3] - gt["T_true"][-1][:3, 3])
    d1 = np.linalg.norm(T_pg[-1][:3, 3] - gt["T_true"][-1][:3, 3])
    assert d1 < 0.35 * d0, (d0, d1)

    # The global BA (gauge: the candidate keyframe); no LM accept flips here.
    assert abs(tstore["chi2"] - jstore["chi2"]) <= 1e-4 * jstore["chi2"]
    slots = gt["slots"]
    np.testing.assert_allclose(tvm.keyframes.T_cw[slots], jvm.keyframes.T_cw[slots], atol=1e-4, rtol=0)
    v = tvm.points.valid
    np.testing.assert_allclose(tvm.points.X_w[v], jvm.points.X_w[v], atol=5e-4, rtol=0)


def test_correct_landmarks_moves_lines_planes_and_moments():
    """tests/test_loop_landmarks.py's case on the port, and the same
    correction through the JAX package: equal within 1e-5."""
    def build(VOConfig_, Capacities_, VOMap_):
        cfg = VOConfig_(cap=Capacities_(keypoints=32, map_points=64, map_lines=16, map_planes=8, keyframes=4,
                                        lines=8, planes=4))
        vm = VOMap_(cfg)
        C = cfg.cap.keypoints
        k0 = vm.add_keyframe(np.eye(4, dtype=np.float32), 0, np.full((C,), -1, np.int32),
                             np.zeros((C, 3), np.float32), np.zeros((C,), np.int32),
                             np.zeros((C, 8), np.uint32), np.zeros((C,), bool))
        rng = np.random.RandomState(0)
        X = rng.randn(5, 3).astype(np.float32)
        pids = vm.add_points(X, np.zeros((5, 8), np.uint32), np.zeros((5, 3), np.float32), np.zeros((5,), np.int32), 0)
        vm.points.first_kf[pids] = k0
        L0 = rng.randn(3, 3).astype(np.float32)
        vm.add_lines(L0, L0 + rng.randn(3, 3).astype(np.float32), np.zeros((3, 36), np.float32), 0, first_kf=k0)
        pts = rng.randn(50, 3) * np.array([1.0, 1.0, 0.0]) + np.array([0, 0, 1.0])
        plid = vm.add_planes(np.array([[0, 0, 1, -1]], np.float32), pts.mean(0)[None].astype(np.float32),
                             np.array([50.0], np.float32), 0, cov_w=np.cov(pts.T, bias=True)[None], first_kf=k0)
        return cfg, vm, k0, pts, plid

    c, s = np.cos(0.4), np.sin(0.4)
    M = np.eye(4)
    M[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    M[:3, 3] = [0.5, -0.2, 0.8]
    maps = []
    for VOConfig_, Capacities_, VOMap_, LC in ((JaxVOConfig, JaxCapacities, JaxVOMap, jlc_mod.LoopCloser),
                                               (VOConfig, Capacities, VOMap,
                                                lambda cfg, vm: LoopCloser(cfg, vm, "cpu"))):
        cfg, vm, k0, pts, plid = build(VOConfig_, Capacities_, VOMap_)
        T_old = vm.keyframes.T_cw[[k0]].astype(np.float64)
        LC(cfg, vm)._correct_landmarks(np.array([k0]), T_old, (T_old[0] @ np.linalg.inv(M))[None])
        maps.append(vm)
    _tables_equal(maps[0], maps[1], ("points", "lines", "planes"), atol=1e-5)
    vm = maps[1]
    pi = vm.planes.pi_w[plid[0]]
    pts_new = pts @ M[:3, :3].T + M[:3, 3]
    assert np.abs(pts_new @ pi[:3] + pi[3]).max() < 1e-4
    vm._refit_planes(np.asarray(plid))
    pi2 = vm.planes.pi_w[plid[0]]
    np.testing.assert_allclose(np.sign(pi2[:3] @ pi[:3]) * pi2, pi, atol=1e-4)


def test_consistency_gate_requires_consecutive_detection():
    """One isolated BoW hit does not reach geometric verification
    (tests/test_loop_landmarks.py's case on the port)."""
    cfg = VOConfig(cap=Capacities(keypoints=16, map_points=64, keyframes=64, lines=8, planes=4,
                                  map_lines=16, map_planes=8))
    vm = VOMap(cfg)
    C = cfg.cap.keypoints
    rng = np.random.RandomState(1)
    pids = vm.add_points(rng.randn(40, 3).astype(np.float32), np.zeros((40, 8), np.uint32),
                         np.zeros((40, 3), np.float32), np.zeros((40,), np.int32), 0)
    for i in range(20):  # 20 keyframes with disjoint observations: none covisible
        point_id = np.full((C,), -1, np.int32)
        point_id[:2] = pids[2 * i: 2 * i + 2]
        vm.add_keyframe(np.eye(4, dtype=np.float32), i, point_id, np.zeros((C, 3), np.float32),
                        np.zeros((C,), np.int32), np.zeros((C, 8), np.uint32), point_id >= 0)
    db = KeyFrameDatabase(cfg.cap.keyframes)
    db.valid[:20] = True
    h = rng.rand(db.hists.shape[1]).astype(np.float32)
    h /= h.sum()
    db.hists[:20] = rng.rand(20, db.hists.shape[1]).astype(np.float32)
    db.hists[:20] /= db.hists[:20].sum(axis=1, keepdims=True)
    db.hists[2] = db.hists[19] = h  # keyframe 2 and the newest look alike
    lc = LoopCloser(cfg, vm, "cpu", min_gap_kfs=5, min_score=0.1)
    trk = types.SimpleNamespace(kf_db=db)
    cur = vm.newest_kf_slot
    assert lc._detect_candidate(trk, cur) is None and lc._consistency_count == 1
    assert lc._detect_candidate(trk, cur) == 2 and lc._consistency_count == 2


def test_convert_carries_auto_reset_and_loop_state():
    """A JAX tracker's `auto_reset` and loop-closer state (closures made,
    the last loop's order, the consistency gate's count and group) load
    into the port's tracker, so a JAX state can seed a port closure."""
    from hfvo_tpu.tracking.tracker import Tracker as JaxTracker
    from hfvo_tpu_torch import convert
    from hfvo_tpu_torch.tracking.tracker import Tracker

    jt = JaxTracker(jax_tum3(), auto_reset=False)
    lc = jt.loop_closer
    lc.n_loops_closed, lc.last_loop_order, lc._consistency_count, lc._consistent_group = 2, 31, 1, {4, 5, 9}
    state = convert.tracker_state_numpy(jt)
    pt = Tracker(tum3_config(), "cpu")
    assert pt.auto_reset and pt.loop_closer._consistency_count == 0
    convert.tracker_state_from_numpy(pt, state)
    assert not pt.auto_reset
    plc = pt.loop_closer
    assert (plc.n_loops_closed, plc.last_loop_order, plc._consistency_count, plc._consistent_group) == (
        2, 31, 1, {4, 5, 9})
    assert convert.tracker_state_numpy(pt)["loop_closer"] == state["loop_closer"]
