"""The distributed layer on the tracking paths, on the CPU over gloo:
`BatchTracker(mesh=...)` with the sequence axis split over 2 ranks,
`LocalMapper(use_distributed=True)` with local BA split over 2 ranks, the
one-rank behaviour of both (the JAX package runs both options on one
device), and a rank's failure.

The two tracking jobs run in the groups of 2 ranks that
`dist_runs.compute_runs` spawns for the solvers too (shared with
test_torch_dist_solvers.py, computed once for all xdist workers); the
unsharded batch, the reference, runs in the test process meanwhile. Small
camera (320x240), the JAX package's default configuration
(`tum3_config()`).

Gates:
- the sharded batch of 2 orbits (seeds 0, 7; 6 frames, frame 0 through
  `track_batch`, then `track_batch_async` and `flush`, as
  tests/test_multiseq.py::test_batch_tracker_sharded_mesh): every rank
  returns all S results and trajectories, bit-equal across the ranks; each
  sequence's positions within 1e-2 m of the port's unsharded batch and its
  ATE < 0.02 m (that test's gates); no kernel launch on the CPU;
- the tracker with distributed local BA (5 frames, a keyframe every frame,
  BA capacities cut to 2048 landmarks and 4096 edges): at least one local
  BA run, every run within 5 mm and 0.1 deg of the single-device mapper's
  run on the same map (the local BA rule of test_torch_full_tracker.py::
  test_f_*) with the same observations erased,
  the trajectory bit-equal across the ranks and its ATE < 0.02 m
  (tests/test_dist_ba.py::test_mapper_distributed_ba_end_to_end);
- one rank (an initialized 1-rank group): the distributed options give the
  single-device results bit for bit;
- a rank that raises fails the run within seconds, not at the collective's
  timeout.
"""
import time

import numpy as np
import pytest
import torch.distributed as dist

from hfvo_tpu_torch.bow.database import KeyFrameDatabase
from hfvo_tpu_torch.config import points_only, tum3_config
from hfvo_tpu_torch.io import evaluate
from hfvo_tpu_torch.mapping.local_mapping import LocalMapper
from hfvo_tpu_torch.parallel.mesh import init_process_group, make_mesh
from hfvo_tpu_torch.parallel.multiseq import BatchTracker
from hfvo_tpu_torch.testing import dist_worker, loop_map
from hfvo_tpu_torch.vomap.map import VOMap
from dist_runs import N_FRAMES, N_MAP_FRAMES, WORLD, compute_runs, make_inputs, mapper_cfg
from torch_helpers import half_camera, shared_result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's outputs and the unsharded batch, from the shared runs."""
    inp = shared_result(tmp_path_factory, "dist_inputs", make_inputs)
    _, ranks, ref = shared_result(tmp_path_factory, "dist_runs",
                                  lambda: compute_runs(inp, tmp_path_factory.mktemp("dist_runs")))
    return ranks, ref["batch"]


def _ate(T_wc, est):
    ts = np.arange(len(est)) / 30.0
    return evaluate.ate(ts, T_wc, ts, est, align="origin").rmse


def test_sharded_batch_matches_unsharded(runs):
    ranks, (ref_poses, ref_trajs) = runs
    for r, out in enumerate(ranks):
        b = out["batch"]
        assert b["local_seqs"] == (r, r + 1)
        assert all(s == ["OK", "OK"] for s in b["states"])
        assert b["poses"].shape == (N_FRAMES, 2, 4, 4) and b["trajectories"].shape == (2, N_FRAMES, 4, 4)
        # Positions within 1e-2 m of the unsharded batch, each ATE < 0.02 m.
        gap = np.abs(b["trajectories"][:, :, :3, 3] - ref_trajs[:, :, :3, 3]).max()
        assert gap < 1e-2, gap
        for s in range(2):
            assert _ate(b["T_wc"][s], b["trajectories"][s]) < 0.02
        # The CPU runs the kernels' plain versions.
        assert not any(b["launches"].values()), b["launches"]
    np.testing.assert_allclose(ranks[0]["batch"]["poses"], ref_poses, atol=1e-2, rtol=0)


def test_sharded_batch_equal_across_ranks(runs):
    a, b = (r["batch"] for r in runs[0])
    assert a["states"] == b["states"]
    np.testing.assert_array_equal(a["poses"], b["poses"])
    np.testing.assert_array_equal(a["trajectories"], b["trajectories"])
    # One gather of the results a call that returns some (not the first
    # pipelined call), one for the flush, one of the trajectories; one sum
    # of the "any sequence not OK" flag a pipelined call.
    assert a["collectives"] == {"all_gather": 1 + (N_FRAMES - 2) + 1 + 1, "psum": N_FRAMES - 1}


def test_mapper_distributed_ba_matches_single(runs):
    for out in runs[0]:
        m = out["mapper"]
        assert m["states"] == ["OK"] * N_MAP_FRAMES
        assert m["n_ba_runs"] >= 1 and len(m["runs"]) == m["n_ba_runs"]
        for run in m["runs"]:
            assert run["ran"] == (True, True)
            assert run["dt"] < 5e-3 and run["dr"] < 0.1, run
            assert run["obs_equal"], run
        assert _ate(m["T_wc"], m["trajectory"]) < 0.02
    np.testing.assert_array_equal(runs[0][0]["mapper"]["trajectory"], runs[0][1]["mapper"]["trajectory"])


@pytest.fixture
def one_rank_group(tmp_path):
    """An initialized process group of one rank (gloo), destroyed after."""
    init_process_group(f"file://{tmp_path}/init", 1, 0, "cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_runs_the_single_device_paths(one_rank_group):
    """F1: with an initialized group of one rank, LocalMapper(
    use_distributed=True) runs the single-device BA and BatchTracker with a
    1-rank mesh runs as without one, bit for bit."""
    cfg = mapper_cfg()
    maps = []
    for use_distributed in (False, True):
        vm = VOMap(cfg)
        loop_map.build_loop_map(vm, KeyFrameDatabase(cfg.cap.keyframes), cfg)
        mapper = LocalMapper(cfg, vm, "cpu", use_distributed=use_distributed)
        assert mapper.run_local_ba()
        maps.append(vm)
    np.testing.assert_array_equal(maps[1].keyframes.T_cw, maps[0].keyframes.T_cw)
    np.testing.assert_array_equal(maps[1].points.X_w, maps[0].points.X_w)
    np.testing.assert_array_equal(maps[1].keyframes.obs_valid, maps[0].keyframes.obs_valid)

    seqs = dist_worker.render_orbits((0,), 2, half_camera(), "cpu")
    out = []
    for mesh in (None, make_mesh(n_edge=1, n_seq=1)):
        bt = BatchTracker(points_only(tum3_config()).replace(camera=half_camera()), n_seq=1, device="cpu",
                          use_local_ba=False, mesh=mesh)
        res = [bt.track_batch([seqs[0][1][i]], [seqs[0][2][i]], [np.linalg.inv(seqs[0][0][0])] if i == 0 else None)
               for i in range(2)]
        out.append(np.stack([r[0].T_cw for r in res]))
        assert bt.mesh is mesh and len(bt.trackers) == 1
    np.testing.assert_array_equal(out[1], out[0])


def test_a_rank_failure_fails_the_run(tmp_path):
    """A rank that raises while the other waits in a collective: the run
    fails with that rank's error in seconds (the other rank is stopped), not
    at the 60 s collective timeout."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails"):
        dist_worker.run_ranks([("fail", dict(rank=1))], WORLD, tmp_path, device="cpu", timeout_s=120)
    assert time.monotonic() - t0 < 45
