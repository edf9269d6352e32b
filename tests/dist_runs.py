"""Shared inputs and runs of the distributed layer's CPU tests
(`test_torch_dist_solvers.py`, `test_torch_dist_tracking.py`).

`compute_runs` starts two groups of 2 ranks at once (`hfvo_tpu_torch.
testing.dist_worker`, each joined over TCP through
`parallel.multihost.initialize`) that split the solver jobs and both
tracking jobs between them, about half the rank time each, and computes
the references meanwhile: the JAX package's distributed solvers on the
conftest's 8-device CPU mesh (its local BA in a helper process) and the
port's unsharded batch.
The test files' fixtures take it once for all xdist workers
(`torch_helpers.shared_result`). The problems are the JAX suite's
(tests/test_ba.py, test_dist_ba.py, test_dist_gba.py,
test_dist_pose_graph.py, test_sharded_db.py,
`__graft_entry__.dryrun_multichip`), built from the same seeds with the
same draws, in numpy and the port's geometry (the JAX package's eager
construction costs seconds of compiles).
"""
import dataclasses
import multiprocessing
import socket
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hfvo_tpu.bow.sharded_db import ShardedKeyFrameDatabase as JaxShardedDB
from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.parallel import dist_ba as jdist_ba
from hfvo_tpu.parallel.dist_gba import dist_global_bundle_adjustment as jax_dist_gba
from hfvo_tpu.parallel.dist_lm import dist_pose_step as jax_dist_pose_step
from hfvo_tpu.parallel.dist_pose_graph import dist_optimize_pose_graph as jax_dist_pg
from hfvo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hfvo_tpu.solve.global_ba import GlobalBAProblem as JaxGBAProblem
from hfvo_tpu.solve.pose_graph import PoseGraph as JaxPoseGraph
from hfvo_tpu.testing.ba_fixture import synthetic_ba_problem as jax_fixture
from hfvo_tpu_torch.bow.database import KeyFrameDatabase
from hfvo_tpu_torch.bow.vocab import N_WORDS
from hfvo_tpu_torch.config import tum3_config
from hfvo_tpu_torch.geometry import camera, se3
from hfvo_tpu_torch.parallel.multiseq import BatchTracker
from hfvo_tpu_torch.testing import dist_worker
from hfvo_tpu_torch.testing.ba_fixture import synthetic_ba_problem
from torch_helpers import half_camera

TCAM = tum3_config().camera
JCAM = jax_tum3().camera
WORLD = 2
BA_CASES = ("points", "outliers", "lines", "fixture")
PG_ITERS, GBA_ITERS, LM_ITERS = 12, 8, 10
# The tracking jobs: two orbits at 320x240 through the sharded batch (6
# frames, frame 0 through track_batch, then track_batch_async and flush, as
# tests/test_multiseq.py::test_batch_tracker_sharded_mesh), and a tracker
# with distributed local BA (5 frames, a keyframe every frame, BA capacities
# cut to 2048 landmarks and 4096 edges).
SEEDS = (0, 7)
N_FRAMES = 6
N_MAP_FRAMES = 5


def batch_cfg():
    return tum3_config().replace(camera=half_camera())


def mapper_cfg():
    c = batch_cfg()
    return c.replace(tracking=dataclasses.replace(c.tracking, max_frames_between_kf=1),
                     cap=dataclasses.replace(c.cap, local_points=2048, ba_edges=4096))


def _exp(xi) -> np.ndarray:
    return se3.exp_se3(torch.from_numpy(np.asarray(xi, np.float32))).numpy()


def _project_stereo(T, X) -> np.ndarray:
    return camera.project_stereo(TCAM, se3.transform(torch.from_numpy(T), torch.from_numpy(X))).numpy()


def pose_errors(T_est, T_gt) -> np.ndarray:
    """|log(T_gt inv(T_est))| per pose (tests/test_ba.py::pose_errors)."""
    return se3.log_se3(torch.from_numpy(np.asarray(T_gt, np.float32)) @ se3.inv(
        torch.from_numpy(np.asarray(T_est, np.float32)))).abs().numpy()


def _no_lines(E=1) -> dict:
    return dict(le_kf=np.zeros((E,), np.int32), le_lm=np.zeros((E,), np.int32),
                le_line2d=np.zeros((E, 3), np.float32), le_inv_sigma2=np.zeros((E,), np.float32),
                le_valid=np.zeros((E,), bool))


def make_ba_problem(rng, K=6, P=300, pose_noise=0.02, pt_noise=0.02, obs_noise=0.3, outlier_frac=0.0):
    """tests/test_ba.py::make_ba_problem: K cameras in a line observing P
    landmarks, the first two fixed. Returns (fields, T_gt, X_gt)."""
    X_gt = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P), rng.uniform(3, 7, P)], 1).astype(np.float32)
    xi = np.zeros((K, 6), np.float32)
    xi[:, 0] = [0.15 * k for k in range(K)]
    xi[:, 4] = [0.02 * k for k in range(K)]
    T_gt = _exp(xi)
    e_kf, e_pt, e_obs = [], [], []
    for k in range(K):
        X_c = se3.transform(torch.from_numpy(T_gt[k]), torch.from_numpy(X_gt)).numpy()
        uvr = _project_stereo(T_gt[k], X_gt)
        uvr[:, :2] += rng.normal(size=(P, 2)) * obs_noise
        vis = (X_c[:, 2] > 0.5) & (uvr[:, 0] > 0) & (uvr[:, 0] < 640) & (uvr[:, 1] > 0) & (uvr[:, 1] < 480)
        ids = np.nonzero(vis)[0]
        e_kf += [k] * len(ids)
        e_pt += list(ids)
        e_obs += list(uvr[ids])
    e_obs = np.stack(e_obs).astype(np.float32)
    E = len(e_kf)
    n_out = int(E * outlier_frac)
    if n_out:
        sel = rng.choice(E, n_out, replace=False)
        e_obs[sel, :2] += rng.uniform(15, 60, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    T_init = T_gt.copy()
    for k in range(2, K):
        T_init[k] = _exp(rng.normal(size=6).astype(np.float32) * pose_noise) @ T_gt[k]
    X_init = X_gt + rng.normal(size=(P, 3)).astype(np.float32) * pt_noise
    fields = dict(kf_T_cw=T_init, kf_free=np.arange(K) >= 2, pt_X=X_init, pt_valid=np.ones((P,), bool),
                  e_kf=np.array(e_kf, np.int32), e_pt=np.array(e_pt, np.int32), e_obs=e_obs,
                  e_stereo=np.ones((E,), bool), e_inv_sigma2=np.ones((E,), np.float32),
                  e_valid=np.ones((E,), bool), **_no_lines())
    return fields, T_gt, X_gt


def _pad_landmarks(fields, P_cap=320) -> dict:
    """tests/test_dist_ba.py::_pad_problem_landmarks."""
    pad = P_cap - fields["pt_X"].shape[0]
    return dict(fields, pt_X=np.pad(fields["pt_X"], ((0, pad), (0, 0))), pt_valid=np.pad(fields["pt_valid"], (0, pad)))


def make_line_ba_problem(rng, K=4, P_pts=60, n_lines=24):
    """tests/test_dist_ba.py::make_line_ba_problem: points and line-endpoint
    landmarks (lines along the world x axis) with reprojection,
    point-to-2D-line, axis-pair and cross-line parallel edges."""
    f, T_gt, X_gt = make_ba_problem(rng, K=K, P=P_pts, pose_noise=0.02, pt_noise=0.02, obs_noise=0.2)
    axis = np.array([1.0, 0.0, 0.0], np.float32)
    L0 = np.stack([rng.uniform(-2, 0, n_lines), rng.uniform(-1.5, 1.5, n_lines), rng.uniform(3.5, 6, n_lines)],
                  1).astype(np.float32)
    L1 = L0 + axis * rng.uniform(0.8, 1.5, (n_lines, 1)).astype(np.float32)
    le_kf, le_lm, le_l2d = [], [], []
    for k in range(K):
        uv0, uv1 = _project_stereo(T_gt[k], L0)[:, :2], _project_stereo(T_gt[k], L1)[:, :2]
        dd = uv1 - uv0
        n = np.stack([-dd[:, 1], dd[:, 0]], 1)
        n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-9
        l2d = np.concatenate([n, -(n * uv0).sum(1)[:, None]], 1).astype(np.float32)
        for i in range(n_lines):
            le_kf += [k, k]
            le_lm += [P_pts + i, P_pts + n_lines + i]
            le_l2d += [l2d[i], l2d[i]]
    El = len(le_kf)
    lm_X = np.concatenate([f["pt_X"][:P_pts], L0 + rng.normal(size=(n_lines, 3)).astype(np.float32) * 0.03,
                           L1 + rng.normal(size=(n_lines, 3)).astype(np.float32) * 0.03])
    lp_s = (P_pts + np.arange(n_lines)).astype(np.int32)
    lp_e = (P_pts + n_lines + np.arange(n_lines)).astype(np.int32)
    nq = n_lines - 1
    f.update(pt_X=lm_X, pt_valid=np.ones((P_pts + 2 * n_lines,), bool),
             le_kf=np.array(le_kf, np.int32), le_lm=np.array(le_lm, np.int32), le_line2d=np.stack(le_l2d),
             le_inv_sigma2=np.ones((El,), np.float32), le_valid=np.ones((El,), bool),
             lp_s=lp_s, lp_e=lp_e, lp_axis=np.tile(axis, (n_lines, 1)), lp_w=np.full((n_lines,), 20.0, np.float32),
             lp_valid=np.ones((n_lines,), bool),
             ll_sa=lp_s[:nq], ll_ea=lp_e[:nq], ll_sb=lp_s[1:], ll_eb=lp_e[1:], ll_kind=np.zeros((nq,), np.int32),
             ll_w=np.full((nq,), 10.0, np.float32), ll_valid=np.ones((nq,), bool))
    return f, T_gt, X_gt, L0, L1, axis


def _loop_graph(K=16, seed=1, drift=0.02):
    """tests/test_dist_pose_graph.py::_loop_graph: a drifting loop, exact
    odometry edges and one loop edge. Returns (fields, T_gt)."""
    rng = np.random.default_rng(seed)
    d = np.array([0.0, 0, 0.4, 0, 2 * np.pi / K, 0], np.float32)
    T_gt = [np.eye(4, dtype=np.float32)]
    for k in range(1, K):
        T_gt.append(_exp(d) @ T_gt[-1])
    T_gt = np.stack(T_gt)
    T_init = [T_gt[0]]
    for k in range(1, K):
        rel = T_gt[k] @ np.linalg.inv(T_gt[k - 1])
        T_init.append(_exp(rng.normal(0, drift, 6).astype(np.float32)) @ rel @ T_init[-1])
    e_i = list(range(1, K)) + [0]
    e_j = list(range(0, K - 1)) + [K - 1]
    return dict(T_cw=np.stack(T_init).astype(np.float32), free=np.arange(K) > 0,
                e_i=np.asarray(e_i, np.int32), e_j=np.asarray(e_j, np.int32),
                e_Tij=np.stack([T_gt[i] @ np.linalg.inv(T_gt[j]) for i, j in zip(e_i, e_j)]).astype(np.float32),
                e_weight=np.asarray([1.0] * (K - 1) + [2.0], np.float32)), T_gt


def _gba_problem(K=6, Pn=160, seed=0, noise_px=0.5, pose_noise=0.01):
    """tests/test_dist_gba.py::_make_problem (mono observations, an empty
    line-edge table of 8 rows). Returns (fields, T_gt)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, Pn), rng.uniform(-1.5, 1.5, Pn), rng.uniform(2.5, 6.0, Pn)],
                 axis=1).astype(np.float32)
    T_gt = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for k in range(K):
        T_gt[k, :3, 3] = [0.08 * k, 0.02 * k, 0.0]
    e_kf, e_pt, e_obs = [], [], []
    for k in range(K):
        Xc = (T_gt[k, :3, :3] @ X.T).T + T_gt[k, :3, 3]
        u = TCAM.fx * Xc[:, 0] / Xc[:, 2] + TCAM.cx + rng.normal(0, noise_px, Pn)
        v = TCAM.fy * Xc[:, 1] / Xc[:, 2] + TCAM.cy + rng.normal(0, noise_px, Pn)
        idx = np.nonzero((u > 0) & (u < TCAM.width) & (v > 0) & (v < TCAM.height))[0]
        e_kf.append(np.full(len(idx), k))
        e_pt.append(idx)
        e_obs.append(np.stack([u[idx], v[idx], -np.ones(len(idx))], axis=1))
    E = sum(len(a) for a in e_kf)
    T_init = T_gt.copy()
    for k in range(1, K):
        T_init[k] = _exp(rng.normal(0, pose_noise, 6).astype(np.float32)) @ T_init[k]
    X_init = X + rng.normal(0, 0.02, X.shape).astype(np.float32)
    El = 8
    return dict(kf_T_cw=T_init, kf_free=np.arange(K) > 0, pt_X=X_init, pt_valid=np.ones((Pn,), bool),
                e_kf=np.concatenate(e_kf).astype(np.int32), e_pt=np.concatenate(e_pt).astype(np.int32),
                e_obs=np.concatenate(e_obs).astype(np.float32), e_stereo=np.zeros((E,), bool),
                e_inv_sigma2=np.ones((E,), np.float32), e_valid=np.ones((E,), bool),
                le_kf=np.zeros((El,), np.int32), le_lm=np.zeros((El,), np.int32),
                le_line2d=np.zeros((El, 3), np.float32), le_inv_sigma2=np.ones((El,), np.float32),
                le_valid=np.zeros((El,), bool)), T_gt


def _np_fields(nt) -> dict:
    return {k: None if v is None else np.asarray(v) for k, v in nt._asdict().items()}


def _rand_hist(rng):
    h = rng.random(N_WORDS).astype(np.float32) ** 8
    return h / h.sum()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_inputs():
    """Every case's host inputs, as numpy, from the JAX suite's seeds."""
    ba = {}
    prob, T_gt, X_gt = make_ba_problem(np.random.default_rng(0), K=6, P=300, pose_noise=0.03, pt_noise=0.03,
                                       obs_noise=0.3)
    ba["points"] = dict(prob=_pad_landmarks(prob), T_gt=T_gt, X_gt=X_gt)
    prob, T_gt, X_gt = make_ba_problem(np.random.default_rng(0), K=6, P=300, pose_noise=0.02, pt_noise=0.02,
                                       obs_noise=0.3, outlier_frac=0.15)
    ba["outliers"] = dict(prob=_pad_landmarks(prob), T_gt=T_gt, X_gt=X_gt)
    prob, T_gt, X_gt, L0, L1, axis = make_line_ba_problem(np.random.default_rng(0))
    ba["lines"] = dict(prob=_pad_landmarks(prob), T_gt=T_gt, X_gt=X_gt, L0=L0, L1=L1, axis=axis)
    prob, T_gt = synthetic_ba_problem(TCAM, 2)
    ba["fixture"] = dict(prob=_np_fields(prob), T_gt=T_gt)

    # The dryrun's step 2: S = 4 sequences of 64 exact stereo observations.
    rng = np.random.default_rng(0)
    S, E = 4, 64
    X = np.stack([rng.uniform(-2, 2, (S, E)), rng.uniform(-1.5, 1.5, (S, E)), rng.uniform(2, 6, (S, E))],
                 axis=-1).astype(np.float32)
    T_gt = se3.exp_se3(torch.from_numpy(rng.normal(size=(S, 6)).astype(np.float32) * 0.05))
    obs = camera.project_stereo(TCAM, se3.transform(T_gt[:, None], torch.from_numpy(X))).numpy()
    lm = dict(T0=np.tile(np.eye(4, dtype=np.float32), (S, 1, 1)), X=X, obs=obs, w=np.ones((S, E), np.float32),
              T_gt=T_gt.numpy())

    pg, T_gt = _loop_graph(K=16, seed=1)
    pg = dict(pg=pg, T_gt=T_gt)

    plain, T_gt = _gba_problem()
    gba = dict(probs=[plain, _gba_with_lines(plain)], T_gt=T_gt)

    rng = np.random.default_rng(0)
    dense_adds = [(k, _rand_hist(rng)) for k in range(40)]
    dense_queries = [(_rand_hist(rng), 5, 3) for _ in range(5)]
    rng = np.random.default_rng(1)
    recall = [_rand_hist(rng) for _ in range(20)]
    dbs = [dict(capacity=64, adds=dense_adds, erases=[7], queries=dense_queries),
           dict(capacity=32, adds=list(enumerate(recall)), erases=[], queries=[(recall[k], None, -1)
                                                                              for k in (0, 9, 19)])]
    return dict(ba=ba, lm=lm, pg=pg, gba=gba, dbs=dbs)


def _gba_with_lines(prob: dict) -> dict:
    """tests/test_dist_gba.py::test_dist_gba_with_line_edges's problem: 8
    line-endpoint edges along exact vertical image lines."""
    X, T0 = prob["pt_X"], prob["kf_T_cw"][0]
    Xc = (T0[:3, :3] @ X[:16].T).T + T0[:3, 3]
    u = TCAM.fx * Xc[:, 0] / Xc[:, 2] + TCAM.cx
    l2d = np.stack([np.ones(16), np.zeros(16), -u], axis=1).astype(np.float32)
    El = prob["le_kf"].shape[0]
    n = min(16, El)
    le_lm = np.zeros((El,), np.int32)
    le_l2d = np.zeros((El, 3), np.float32)
    le_valid = np.zeros((El,), bool)
    le_lm[:n] = np.arange(n)
    le_l2d[:n] = l2d[:n]
    le_valid[:n] = True
    return dict(prob, le_kf=np.zeros((El,), np.int32), le_lm=le_lm, le_line2d=le_l2d, le_valid=le_valid)


def jobs(inp):
    return [
        ("ba", dict(probs=[inp["ba"][k]["prob"] for k in BA_CASES], intr=tuple(TCAM), single=True)),
        ("pose_step", dict(**{k: inp["lm"][k] for k in ("T0", "X", "obs", "w")}, intr=tuple(TCAM),
                           n_iters=LM_ITERS, n_seqs=[2, 1], single=True)),
        ("pose_graph", dict(pg=inp["pg"]["pg"], n_iters=PG_ITERS, single=True)),
        ("gba", dict(probs=inp["gba"]["probs"], intr=tuple(TCAM), n_iters=GBA_ITERS, single=True)),
        ("db", dict(dbs=inp["dbs"])),
        ("mismatch", dict(prob=inp["ba"]["fixture"]["prob"])),
        ("batch", dict(cfg=batch_cfg(), seeds=SEEDS, n=N_FRAMES, intr=half_camera(), async_from=1)),
        ("mapper", dict(cfg=mapper_cfg(), seed=0, n=N_MAP_FRAMES, intr=half_camera())),
    ]


def jax_ba_reference() -> dict:
    """The JAX package's fixture and its distributed BA on the 8-device CPU
    mesh (run in a helper process, beside the other references)."""
    jax.config.update("jax_platforms", "cpu")
    jprob, T_gt = jax_fixture(JCAM, 2)
    kf_T = jdist_ba.dist_local_bundle_adjustment(jax_make_mesh(n_edge=8, n_seq=1),
                                                 jdist_ba.shard_ba_problem(jprob, 8), JCAM)[0]
    return dict(ba_fixture=np.asarray(kf_T), fixture_T_gt=T_gt, fixture_prob=_np_fields(jprob))


def unsharded_batch():
    """The port's batch of the tracking job's orbits without a mesh, the same
    protocol: poses (result, seq, 4, 4) and trajectories."""
    seqs = dist_worker.render_orbits(SEEDS, N_FRAMES, half_camera(), "cpu")
    bt = BatchTracker(batch_cfg(), n_seq=len(SEEDS), device="cpu", use_local_ba=False)
    _, poses = dist_worker.track_orbits(bt, seqs, N_FRAMES, async_from=1)
    return poses, np.stack(bt.get_trajectories())


def _references(inp):
    """The JAX package's distributed solvers on the same inputs (the port's
    single-device ones run in the ranks, `single=True`), the local BA's in a
    helper process meanwhile, and the port's unsharded batch."""
    ref = {"jax": {}}
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        ba = pool.submit(jax_ba_reference)
        _other_references(inp, ref)
        ref["batch"] = unsharded_batch()
        ref["jax"].update(ba.result(timeout=300))
    return ref


# The jobs of each group of ranks: the tracking batch and the rest against
# the pose graph, global BA and the tracker, about 25 s of rank time each.
JOB_GROUPS = (("ba", "pose_step", "db", "mismatch", "batch"), ("pose_graph", "gba", "mapper"))


def compute_runs(inp, workdir):
    """(inputs, each rank's outputs over both groups, references)."""
    by_name = dict(jobs(inp))
    assert sorted(by_name) == sorted(sum(JOB_GROUPS, ()))
    handles = [
        dist_worker.start_ranks([(n, by_name[n]) for n in names], WORLD, Path(workdir) / f"group{g}",
                                device="cpu", coordinator=f"127.0.0.1:{_free_port()}", timeout_s=300)
        for g, names in enumerate(JOB_GROUPS)
    ]
    try:
        ref = _references(inp)
    finally:
        # Join every group, so that no rank outlives a failure of another.
        outs, error = [], None
        for handle in handles:
            try:
                outs.append(dist_worker.join_ranks(handle))
            except Exception as e:  # raised below, once every group is joined
                error = error or e
        if error is not None:
            raise error
    ranks = [{k: v for out in outs for k, v in out[r].items()} for r in range(WORLD)]
    return inp, ranks, ref


def _other_references(inp, ref):
    ref["jax"]["lm"] = np.asarray(jax_dist_pose_step(
        jax_make_mesh(n_edge=4, n_seq=2), jnp.asarray(inp["lm"]["T0"]), jnp.asarray(inp["lm"]["X"]),
        jnp.asarray(inp["lm"]["obs"]), jnp.asarray(inp["lm"]["w"]), JCAM, n_iters=LM_ITERS))

    mesh8 = jax.sharding.Mesh(np.asarray(jax.devices()), ("edge",))
    jpg = {k: jnp.asarray(v) for k, v in inp["pg"]["pg"].items()}
    ref["jax"]["pg"] = np.asarray(jax_dist_pg(mesh8, JaxPoseGraph(**jpg), n_iters=PG_ITERS))

    jg = JaxGBAProblem(**{k: jnp.asarray(v) for k, v in inp["gba"]["probs"][0].items()})
    ref["jax"]["gba"] = np.asarray(jax_dist_gba(mesh8, jg, JCAM, n_iters=GBA_ITERS).kf_T_cw)

    ref["db"] = []
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()), ("kf",))
    ref["jax"]["db"] = []
    for spec in inp["dbs"]:
        dense, jdb = KeyFrameDatabase(spec["capacity"]), JaxShardedDB(jmesh, spec["capacity"])
        for slot, h in spec["adds"]:
            dense.add(slot, h)
            jdb.add(slot, h)
        for slot in spec["erases"]:
            dense.erase(slot)
            jdb.erase(slot)
        ref["db"].append([dense.query(q, top_k=5 if k is None else k, exclude=x) for q, k, x in spec["queries"]])
        ref["jax"]["db"].append([jdb.query(q, top_k=k, exclude=x) for q, k, x in spec["queries"]])


