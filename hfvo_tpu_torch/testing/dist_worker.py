"""Rank workers of the distributed layer's checks.

`run_ranks(jobs, world, workdir)` starts `world` processes
(`torch.multiprocessing`, spawn). Each joins the default process group
through `file://<workdir>/init`, or over TCP through
`parallel.multihost.initialize` when given a coordinator, runs `jobs` in order, each a (name, inputs)
pair that names a function of `JOBS` and gives it a picklable dict that every
rank gets alike, and saves {name: output} to `<workdir>/rank<r>.pt`.
`run_ranks` returns every rank's outputs, in rank order. A rank's exception,
a rank that dies, or a run past `timeout_s` raises in the caller once every
rank has been stopped; each process group has the mesh's 60 s timeout, so a
rank left waiting on a collective fails too. `start_ranks` / `join_ranks`
split it, so that the caller can work while the ranks run.

The ranks run on `device`, the card unless the caller asks for the CPU, as
every entry point of the port does. The CPU tests pass "cpu" and run it over
gloo, and `chip_smoke.py` runs two ranks on one GPU over gloo (NCCL refuses
two ranks on one device). It lives in the package
because a spawned child imports the module of its target, and a test module
imports JAX. Children use one intra-op thread: several ranks, and several
test workers, share the host.
"""
from __future__ import annotations

import copy
import os
import pickle
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..geometry.camera import Intrinsics

# Kernel launch counters a job reports (module, attribute).
_COUNTERS = {
    "fast_score_dual": ("fast", "fast_dual_launches"),
    "fast_score_dual_batched": ("fast", "fast_dual_batched_launches"),
    "hough_vote": ("lines", "hough_vote_launches"),
    "hough_vote_batched": ("lines", "hough_vote_batched_launches"),
}


def _launch_counts() -> Dict[str, int]:
    from ..ops import fast, lines

    mods = {"fast": fast, "lines": lines}
    return {k: int(getattr(mods[m], a)) for k, (m, a) in _COUNTERS.items()}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _tensors(fields: dict, device) -> dict:
    """numpy fields -> tensors on `device` (index tables int64)."""
    out = {}
    for k, v in fields.items():
        if v is None:
            out[k] = None
            continue
        a = np.asarray(v)
        out[k] = torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a).to(device)
    return out


def pose_gap(Ta, Tb) -> Tuple[float, float]:
    """(metres, degrees) between two poses, in float64."""
    D = np.asarray(Ta, np.float64) @ np.linalg.inv(np.asarray(Tb, np.float64))
    R = D[:3, :3]
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return (float(np.linalg.norm(np.asarray(Ta)[:3, 3] - np.asarray(Tb)[:3, 3])),
            float(np.degrees(np.arctan2(s, 0.5 * (np.trace(R) - 1)))))


# ---- jobs: each takes (inputs, device) and returns numpy -------------------
# With inp["single"] (for "ba", a flag per problem or one for all), a solver
# job also runs the single-device solver on the same inputs (the reference of
# the distributed one), outside the timing.


def job_ba(inp: dict, device) -> dict:
    """`dist_local_bundle_adjustment` on each problem of inp["probs"] (BAProblem
    fields as numpy, blocked by `shard_ba_problem` with the pairs it derives)
    over every rank, with the final gate in the problem's own edge order."""
    from ..parallel.dist_ba import dist_local_bundle_adjustment, shard_ba_problem, unshard_points
    from ..parallel.mesh import make_mesh
    from ..solve.ba import BAProblem, final_gate, local_bundle_adjustment

    intr = Intrinsics(*inp["intr"])
    mesh = make_mesh()
    out = []
    for i, fields in enumerate(inp["probs"]):
        sp = shard_ba_problem(BAProblem(**fields), mesh.shape["edge"])
        mesh.counts.clear()
        t0 = time.perf_counter()
        kf_T, pt_X, e_inl, le_inl = dist_local_bundle_adjustment(mesh, sp, intr, device=device)
        pt_orig = unshard_points(sp, pt_X)
        gate = final_gate(BAProblem(**_tensors(fields, device)), kf_T, torch.from_numpy(pt_orig).to(device), intr)
        secs = time.perf_counter() - t0
        out.append(dict(
            kf_T=_np(kf_T), pt_X_perm=_np(pt_X), pt_X=pt_orig, e_inlier=_np(e_inl), le_inlier=_np(le_inl),
            e_valid=sp.e_valid, le_valid=sp.le_valid, new_of_old=sp.new_of_old, n_dropped=sp.n_dropped,
            chi2=float(gate.chi2), e_inlier_orig=_np(gate.e_inlier), le_inlier_orig=_np(gate.le_inlier),
            collectives=dict(mesh.counts), seconds=secs,
        ))
        single = inp.get("single")
        if single[i] if isinstance(single, (list, tuple)) else single:
            res = local_bundle_adjustment(BAProblem(**_tensors(fields, device)), intr)
            out[-1].update(single_kf_T=_np(res.kf_T_cw), single_pt_X=_np(res.pt_X), single_chi2=float(res.chi2))
    return {"runs": out}


def job_pose_step(inp: dict, device) -> dict:
    """`dist_pose_step` on a (n_seq, world / n_seq) mesh for each n_seq of
    inp["n_seqs"]."""
    from ..parallel.dist_lm import dist_pose_step
    from ..parallel.mesh import Mesh, make_mesh

    t = _tensors({k: inp[k] for k in ("T0", "X", "obs", "w")}, device)
    out = []
    for n_seq in inp["n_seqs"]:
        mesh = make_mesh(n_seq=n_seq)
        t0 = time.perf_counter()
        T = dist_pose_step(mesh, t["T0"], t["X"], t["obs"], t["w"], Intrinsics(*inp["intr"]),
                           n_iters=inp["n_iters"])
        out.append(dict(T=_np(T), mesh=dict(mesh.shape), collectives=dict(mesh.counts),
                        seconds=time.perf_counter() - t0))
    one = {}
    if inp.get("single"):  # this rank alone: a 1-rank mesh
        one["single_T"] = _np(dist_pose_step(Mesh(1, 1, {"seq": 0, "edge": 0}, {}, None), t["T0"], t["X"],
                                             t["obs"], t["w"], Intrinsics(*inp["intr"]), n_iters=inp["n_iters"]))
    return {"runs": out, **one}


def job_pose_graph(inp: dict, device) -> dict:
    from ..parallel.dist_pose_graph import dist_optimize_pose_graph
    from ..parallel.mesh import make_mesh
    from ..solve.pose_graph import PoseGraph, optimize_pose_graph

    mesh = make_mesh()
    pg = PoseGraph(**_tensors(inp["pg"], device))
    t0 = time.perf_counter()
    T = dist_optimize_pose_graph(mesh, pg, n_iters=inp["n_iters"])
    out = dict(T=_np(T), collectives=dict(mesh.counts), seconds=time.perf_counter() - t0)
    if inp.get("single"):
        out["single_T"] = _np(optimize_pose_graph(pg, n_iters=inp["n_iters"]))
    return out


def job_gba(inp: dict, device) -> dict:
    from ..parallel.dist_gba import dist_global_bundle_adjustment
    from ..parallel.mesh import make_mesh
    from ..solve.global_ba import GlobalBAProblem, global_bundle_adjustment

    mesh = make_mesh()
    out = []
    for fields in inp["probs"]:
        mesh.counts.clear()
        t0 = time.perf_counter()
        prob = GlobalBAProblem(**_tensors(fields, device))
        res = dist_global_bundle_adjustment(mesh, prob, Intrinsics(*inp["intr"]), n_iters=inp["n_iters"])
        out.append(dict(kf_T=_np(res.kf_T_cw), pt_X=_np(res.pt_X), chi2=float(res.chi2),
                        e_inlier=_np(res.e_inlier), le_inlier=_np(res.le_inlier),
                        collectives=dict(mesh.counts), seconds=time.perf_counter() - t0))
        if inp.get("single"):
            single = global_bundle_adjustment(prob, Intrinsics(*inp["intr"]), n_iters=inp["n_iters"])
            out[-1].update(single_kf_T=_np(single.kf_T_cw), single_chi2=float(single.chi2))
    return {"runs": out}


def job_db(inp: dict, device) -> dict:
    """For each database of inp["dbs"], a `ShardedKeyFrameDatabase` of its
    "capacity": its "adds" (slot, hist), its "erases", then its "queries"
    (hist, top_k or None, exclude)."""
    from ..bow.sharded_db import ShardedKeyFrameDatabase
    from ..parallel.mesh import make_mesh

    mesh = make_mesh()
    out = []
    for spec in inp["dbs"]:
        db = ShardedKeyFrameDatabase(mesh, spec["capacity"], device=device)
        for slot, h in spec["adds"]:
            db.add(slot, h)
        for slot in spec["erases"]:
            db.erase(slot)
        mesh.counts.clear()
        t0 = time.perf_counter()
        res = [db.query(q, top_k=k, exclude=x) for q, k, x in spec["queries"]]
        out.append(dict(results=res, capacity=db.capacity, collectives=dict(mesh.counts),
                        seconds=time.perf_counter() - t0))
    return {"runs": out}


def job_mismatch(inp: dict, device) -> dict:
    """Each rank builds a different problem (inp["prob"] with pt_X moved by
    its rank): `globalize_sharded_ba` must refuse it on every rank. Returns
    the error."""
    from ..parallel.dist_ba import shard_ba_problem
    from ..parallel.mesh import make_mesh
    from ..parallel.multihost import globalize_sharded_ba
    from ..solve.ba import BAProblem

    mesh = make_mesh()
    fields = dict(inp["prob"], pt_X=inp["prob"]["pt_X"] + np.float32(torch.distributed.get_rank()))
    try:
        globalize_sharded_ba(shard_ba_problem(BAProblem(**fields), mesh.shape["edge"]), mesh, device)
    except RuntimeError as e:
        return {"error": str(e)}
    return {"error": None}


def dryrun_inputs(intr: Intrinsics, n_devices: int) -> dict:
    """The inputs of the JAX package's five-path distributed dry run
    (`__graft_entry__.dryrun_multichip`, :42-217) at `n_devices`, built from
    its seed and draws in numpy and this package's geometry: the synthetic
    BA fixture; the sequence-parallel pose LM's exact stereo observations;
    the global BA's K = 6 keyframes and 160 points with exact mono
    observations; the 16-keyframe drifted loop of the pose graph; 40 BoW
    histograms and a query. Each with its ground truth where it has one."""
    from ..bow.vocab import N_WORDS
    from ..geometry import camera, se3
    from .ba_fixture import synthetic_ba_problem

    def exp(xi):
        return se3.exp_se3(torch.from_numpy(np.asarray(xi, np.float32))).numpy()

    rng = np.random.default_rng(0)
    prob, T_gt = synthetic_ba_problem(intr, n_devices)
    out = {"ba": dict(prob={k: None if v is None else v.numpy() for k, v in prob._asdict().items()}, T_gt=T_gt)}

    n_seq = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    S, E = n_seq * 2, 64 * (n_devices // n_seq)
    X = np.stack([rng.uniform(-2, 2, (S, E)), rng.uniform(-1.5, 1.5, (S, E)), rng.uniform(2, 6, (S, E))],
                 axis=-1).astype(np.float32)
    T_gt = exp(rng.normal(size=(S, 6)).astype(np.float32) * 0.05)
    obs = camera.project_stereo(intr, se3.transform(torch.from_numpy(T_gt)[:, None], torch.from_numpy(X)))
    out["lm"] = dict(T0=np.tile(np.eye(4, dtype=np.float32), (S, 1, 1)), X=X, obs=obs.numpy(),
                     w=np.ones((S, E), np.float32), T_gt=T_gt, n_seq=n_seq)

    K, Pn = 6, 160
    X = np.stack([rng.uniform(-2, 2, Pn), rng.uniform(-1.5, 1.5, Pn), rng.uniform(2.5, 6.0, Pn)],
                 axis=1).astype(np.float32)
    T_gt = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for k in range(K):
        T_gt[k, :3, 3] = [0.08 * k, 0.02 * k, 0.0]
    e_kf, e_pt, e_obs = [], [], []
    for k in range(K):
        Xc = (T_gt[k, :3, :3] @ X.T).T + T_gt[k, :3, 3]
        u = intr.fx * Xc[:, 0] / Xc[:, 2] + intr.cx
        v = intr.fy * Xc[:, 1] / Xc[:, 2] + intr.cy
        idx = np.nonzero((u > 0) & (u < intr.width) & (v > 0) & (v < intr.height))[0]
        e_kf.append(np.full(len(idx), k))
        e_pt.append(idx)
        e_obs.append(np.stack([u[idx], v[idx], -np.ones(len(idx))], axis=1))
    E = sum(len(a) for a in e_kf)
    T_init = T_gt.copy()
    for k in range(1, K):
        T_init[k] = exp(rng.normal(0, 0.01, 6).astype(np.float32)) @ T_init[k]
    El = 8
    out["gba"] = dict(prob=dict(
        kf_T_cw=T_init, kf_free=np.arange(K) > 0,
        pt_X=X + rng.normal(0, 0.02, X.shape).astype(np.float32), pt_valid=np.ones((Pn,), bool),
        e_kf=np.concatenate(e_kf).astype(np.int32), e_pt=np.concatenate(e_pt).astype(np.int32),
        e_obs=np.concatenate(e_obs).astype(np.float32), e_stereo=np.zeros((E,), bool),
        e_inv_sigma2=np.ones((E,), np.float32), e_valid=np.ones((E,), bool),
        le_kf=np.zeros((El,), np.int32), le_lm=np.zeros((El,), np.int32), le_line2d=np.zeros((El, 3), np.float32),
        le_inv_sigma2=np.ones((El,), np.float32), le_valid=np.zeros((El,), bool)), T_gt=T_gt)

    Kp = 16
    step = exp(np.array([0.0, 0, 0.4, 0, 2 * np.pi / Kp, 0], np.float32))
    T_gtp = [np.eye(4, dtype=np.float32)]
    for k in range(1, Kp):
        T_gtp.append(step @ T_gtp[-1])
    T_ip = [T_gtp[0]]
    for k in range(1, Kp):
        rel = T_gtp[k] @ np.linalg.inv(T_gtp[k - 1])
        T_ip.append(exp(rng.normal(0, 0.02, 6).astype(np.float32)) @ rel @ T_ip[-1])
    e_i = list(range(1, Kp)) + [0]
    e_j = list(range(0, Kp - 1)) + [Kp - 1]
    out["pg"] = dict(pg=dict(
        T_cw=np.stack(T_ip).astype(np.float32), free=np.arange(Kp) > 0,
        e_i=np.asarray(e_i, np.int32), e_j=np.asarray(e_j, np.int32),
        e_Tij=np.stack([T_gtp[i] @ np.linalg.inv(T_gtp[j]) for i, j in zip(e_i, e_j)]).astype(np.float32),
        e_weight=np.asarray([1.0] * (Kp - 1) + [2.0], np.float32)), T_gt=np.stack(T_gtp))

    hists = []
    for _ in range(40):
        h = rng.random(N_WORDS).astype(np.float32) ** 8
        hists.append(h / h.sum())
    q = rng.random(N_WORDS).astype(np.float32) ** 8
    out["db"] = dict(capacity=64, adds=list(enumerate(hists)), erases=[], queries=[(q / q.sum(), 5, 3)])
    return out


def render_orbits(seeds: Sequence[int], n: int, intr, device) -> list:
    """(T_wc, grays, depths) of the renderer's orbits of `seeds`."""
    from . import synthetic

    return [synthetic.render_sequence(n=n, intr=intr, seed=s, device=device) for s in seeds]


def track_orbits(bt, seqs, n: int, async_from=None):
    """Drive a BatchTracker over the first n frames of `seqs` (each
    initialized at its first frame with its ground-truth pose), through
    `track_batch`, or from frame `async_from` on through
    `track_batch_async` (then `flush`). Returns the state names and T_cw
    (frame, seq) of the results in the order they came."""
    states, poses = [], []
    for i in range(n):
        grays, depths = [q[1][i] for q in seqs], [q[2][i] for q in seqs]
        if async_from is not None and i >= async_from:
            res = bt.track_batch_async(grays, depths)
        else:
            res = bt.track_batch(grays, depths, [np.linalg.inv(q[0][0]) for q in seqs] if i == 0 else None)
        states += [r.state.name for r in res]
        poses += [r.T_cw for r in res]
    if async_from is not None:
        res = bt.flush()
        states += [r.state.name for r in res]
        poses += [r.T_cw for r in res]
    S = len(seqs)
    return [states[k:k + S] for k in range(0, len(states), S)], np.stack(poses).reshape(-1, S, 4, 4)


def job_batch(inp: dict, device) -> dict:
    """`BatchTracker(cfg, S, mesh=make_mesh(n_edge=1, n_seq=world))` over the
    orbits of inp["seeds"] (`track_orbits`: inp["n"] frames, from
    inp["async_from"] on pipelined); the kernels' launches on this rank and
    the collectives of the run."""
    from ..parallel.mesh import make_mesh
    from ..parallel.multiseq import BatchTracker

    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    mesh = make_mesh(n_edge=1, n_seq=world)
    seqs = render_orbits(inp["seeds"], inp["n"], inp.get("intr"), device)
    bt = BatchTracker(inp["cfg"], n_seq=len(seqs), device=device, use_local_ba=False, mesh=mesh)
    bt.warmup()
    before = _launch_counts()
    t0 = time.perf_counter()
    states, poses = track_orbits(bt, seqs, inp["n"], inp.get("async_from"))
    trajs = bt.get_trajectories()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    after = _launch_counts()
    return dict(states=states, poses=poses, trajectories=np.stack(trajs),
                T_wc=np.stack([q[0] for q in seqs]), launches={k: after[k] - before[k] for k in after},
                local_seqs=(bt._seqs.start, bt._seqs.stop), collectives=dict(mesh.counts), seconds=secs)


def job_mapper(inp: dict, device) -> dict:
    """A `Tracker` with local BA split over the ranks (`LocalMapper(
    use_distributed=True)`) over the first n frames of an orbit; before each
    local BA run, the same run by the single-device mapper on a copy of the
    map, and the two runs' keyframe poses and landmarks compared."""
    from ..mapping.local_mapping import LocalMapper
    from ..tracking.tracker import Tracker

    (T_wc, grays, depths), = render_orbits([inp["seed"]], inp["n"], inp.get("intr"), device)
    tr = Tracker(inp["cfg"], device, use_local_ba=True, use_loop_closing=False)
    mapper = tr.mapper
    mapper.use_distributed = True
    dist_run = mapper.run_local_ba
    runs = []

    def compared():
        single = LocalMapper(mapper.cfg, copy.deepcopy(mapper.vomap), device, R_wm=copy.deepcopy(mapper.R_wm),
                             manh_valid=mapper.manh_valid)
        ran_single = single.run_local_ba()
        t0 = time.perf_counter()
        ran = dist_run()
        secs = time.perf_counter() - t0
        if ran or ran_single:
            kf = mapper.vomap.keyframes
            slots = np.nonzero(kf.valid)[0]
            gaps = [pose_gap(a, b) for a, b in zip(kf.T_cw[slots], single.vomap.keyframes.T_cw[slots])]
            pts = mapper.vomap.points
            on = pts.valid & single.vomap.points.valid
            dX = np.linalg.norm(pts.X_w[on] - single.vomap.points.X_w[on], axis=1)
            runs.append(dict(ran=(ran, ran_single), dt=max(g[0] for g in gaps), dr=max(g[1] for g in gaps),
                             point_gap_median=float(np.median(dX)) if len(dX) else 0.0,
                             obs_equal=bool(np.array_equal(kf.obs_valid, single.vomap.keyframes.obs_valid)),
                             seconds=secs))
        return ran

    mapper.run_local_ba = compared
    states = []
    for i in range(inp["n"]):
        states.append(tr.track_rgbd(grays[i], depths[i], T_cw_init=np.linalg.inv(T_wc[0])).state.name)
    return dict(runs=runs, states=states, trajectory=tr.get_trajectory(), T_wc=T_wc,
                n_ba_runs=mapper.n_ba_runs)


def job_fail(inp: dict, device) -> dict:
    """Rank inp["rank"] raises; the others wait for it in a collective."""
    from ..parallel.mesh import make_mesh

    if torch.distributed.get_rank() == inp["rank"]:
        raise RuntimeError(f"rank {inp['rank']} fails")
    make_mesh().psum(torch.ones(1))
    return {}


JOBS = {
    "ba": job_ba,
    "pose_step": job_pose_step,
    "pose_graph": job_pose_graph,
    "gba": job_gba,
    "db": job_db,
    "mismatch": job_mismatch,
    "fail": job_fail,
    "batch": job_batch,
    "mapper": job_mapper,
}


# ---- the ranks ---------------------------------------------------------------


def _rank_main(rank: int, world: int, workdir: str, device: str, backend, coordinator) -> None:
    import torch.distributed as dist

    import hfvo_tpu_torch  # noqa: F401  (fp32 policy)
    from ..parallel import multihost
    from ..parallel.mesh import init_process_group

    torch.set_num_threads(1)
    dev = torch.device(device)
    jobs = torch.load(Path(workdir) / "jobs.pt", weights_only=False)
    if coordinator:
        multihost.initialize(coordinator, world, rank, dev, backend)
    else:
        init_process_group(f"file://{workdir}/init", world, rank, dev, backend)
    try:
        out = {}
        for name, inp in jobs:
            t0 = time.perf_counter()
            out[name] = JOBS[name](inp, dev)
            out[name]["job_seconds"] = time.perf_counter() - t0
        torch.save(out, Path(workdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def start_ranks(jobs: List[tuple], world: int, workdir, device: str = "cuda", backend=None,
                coordinator=None, timeout_s: float = 600.0):
    """Start `jobs` on `world` spawned ranks (see the module docstring); the
    ranks meet at `coordinator` ("host:port") over TCP if given. Returns the
    handle `join_ranks` takes."""
    import torch.multiprocessing as mp

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    # The jobs go through a file: a spawned child reads its arguments only
    # after its imports, and large ones would hold the caller until then.
    torch.save(jobs, workdir / "jobs.pt")
    ctx = mp.start_processes(_rank_main, args=(world, str(workdir), device, backend, coordinator),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, workdir, world, time.monotonic() + timeout_s


def join_ranks(handle) -> List[dict]:
    """Wait for the ranks of `start_ranks`; returns each rank's {job name:
    output}. Raises if a rank failed or the run outlasted its time."""
    ctx, workdir, world, deadline = handle
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world} ranks did not finish in time")
    except Exception as e:
        # Every rank's traceback, not only the first rank to end's (a rank
        # whose peer failed ends too, by a signal or a broken connection).
        errors = []
        for r, path in enumerate(ctx.error_files):
            if os.path.exists(path) and os.path.getsize(path):
                with open(path, "rb") as f:
                    errors.append(f"rank {r}:\n{pickle.load(f)}")
        raise RuntimeError("\n".join(errors) or str(e)) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def run_ranks(jobs: List[tuple], world: int, workdir, **kw) -> List[dict]:
    """`join_ranks(start_ranks(jobs, world, workdir, **kw))`."""
    return join_ranks(start_ranks(jobs, world, workdir, **kw))
