"""The distributed solvers of the port (`hfvo_tpu_torch/parallel/`,
`bow/sharded_db.py`) on two gloo ranks on the CPU, against the port's
single-device solvers and, one case per solver, against the JAX package's
distributed functions on the conftest's 8-device CPU mesh.

The ranks' runs and the references come from `dist_runs.compute_runs`
(two spawned groups of 2 ranks, each with part of the jobs, joined over
TCP through `multihost.initialize`, shared with test_torch_dist_tracking.py and
computed once for all xdist workers); the problems are the JAX suite's,
built as `dist_runs` says.

Gates (the JAX suite's where it has one):
- `shard_ba_problem` at 2 and 8 ranks: `new_of_old`, every block and
  `n_dropped` equal to the JAX package's;
- local BA, points: poses within 0.01 of the truth, |max pose error of the
  distributed run - of the single-device one| < 0.01, landmark median
  < 0.01 m; with 15 % outliers: poses within 0.02, 60-95 % of the edges
  kept; with line edges, axis pairs and cross-line edges: the JAX file's
  gates, endpoint pairs on one rank; the synthetic fixture (exact
  observations): twist error < 1e-5, and the JAX package's distributed BA
  within 1e-5 of the port's;
- pose LM (the dryrun's step 2, on a (2, 1) and a (1, 2) mesh): twist error
  < 1e-5; within 1e-5 of the JAX package's `dist_pose_step` and of the
  port's at one rank;
- pose graph and global BA (line edges included): within 1e-4 of the port's
  single-device solver and of the JAX package's distributed one;
- sharded database: top-5 equal to the dense database's, scores within
  1e-5, self-recall score > 0.999, equal to the JAX package's;
- every solver: the replicated outputs bit-equal on the two ranks; the
  collectives a solve as each module documents them; a rank whose host
  problem differs is refused by both ranks;
- four ranks as a (2, 2) mesh (its sub-groups made by `dist.new_group`):
  the pose LM and the fixture's local BA reach the truth, bit-equal on
  every rank (a group of its own, one test).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfvo_tpu.parallel import dist_ba as jdist_ba
from hfvo_tpu.solve.ba import BAProblem as JaxBAProblem
from hfvo_tpu_torch.geometry import se3
from hfvo_tpu_torch.parallel import dist_ba
from hfvo_tpu_torch.solve.ba import BAProblem
from hfvo_tpu_torch.testing import dist_worker
from dist_runs import BA_CASES, GBA_ITERS, LM_ITERS, PG_ITERS, TCAM, WORLD, compute_runs, make_inputs, pose_errors
from torch_helpers import shared_result


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return shared_result(tmp_path_factory, "dist_inputs", make_inputs)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """(inputs, each rank's outputs, references), shared with
    test_torch_dist_tracking.py."""
    return shared_result(tmp_path_factory, "dist_runs",
                         lambda: compute_runs(inputs, tmp_path_factory.mktemp("dist_runs")))


# ---- shard_ba_problem (host code, no process) -------------------------------


@pytest.mark.parametrize("ndev", [2, 8])
@pytest.mark.parametrize("case", ["outliers", "lines"])
def test_shard_ba_problem_equals_jax(inputs, ndev, case):
    fields = inputs["ba"][case]["prob"]
    prob = JaxBAProblem(**{k: None if v is None else jnp.asarray(v) for k, v in fields.items()})
    want = jdist_ba.shard_ba_problem(prob, ndev)
    got = dist_ba.shard_ba_problem(BAProblem(**fields), ndev)
    assert got.n_dropped == want.n_dropped == 0
    np.testing.assert_array_equal(got.new_of_old, want.new_of_old)
    for f in dist_ba.EDGE_FIELDS + dist_ba.REPL_FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if case == "lines":
        # Every line's endpoint pair sits in one rank's block.
        blk = got.pt_X.shape[0] // ndev
        s_new = got.new_of_old[fields["lp_s"]]
        e_new = got.new_of_old[fields["lp_e"]]
        assert (s_new // blk == e_new // blk).all()


def test_ba_fixture_equals_jax(runs):
    """testing/ba_fixture.py builds the JAX package's problem."""
    inp, _, ref = runs
    got = inp["ba"]["fixture"]
    np.testing.assert_allclose(got["T_gt"], ref["jax"]["fixture_T_gt"], atol=1e-6, rtol=0)
    for f, b in ref["jax"]["fixture_prob"].items():
        a = got["prob"][f]
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.shape == b.shape, f
            np.testing.assert_allclose(a.astype(b.dtype), b, atol=1e-3, rtol=0, err_msg=f)


# ---- local BA ---------------------------------------------------------------------


def _ba_run(runs, case, rank=0):
    return runs[1][rank]["ba"]["runs"][BA_CASES.index(case)]


def test_dist_ba_points_match_single(runs):
    inp = runs[0]
    d, c = _ba_run(runs, "points"), inp["ba"]["points"]
    assert d["n_dropped"] == 0
    perr_d, perr_s = pose_errors(d["kf_T"], c["T_gt"]), pose_errors(d["single_kf_T"], c["T_gt"])
    assert perr_d[2:, :3].max() < 0.01, perr_d
    assert abs(perr_d.max() - perr_s.max()) < 0.01
    for X in (d["pt_X"], d["single_pt_X"]):
        assert np.median(np.linalg.norm(X[:300] - c["X_gt"], axis=1)) < 0.01


def test_dist_ba_outlier_gating(runs):
    inp, _, _ = runs
    d = _ba_run(runs, "outliers")
    assert pose_errors(d["kf_T"], inp["ba"]["outliers"]["T_gt"])[2:, :3].max() < 0.02
    frac = d["e_inlier"].sum() / d["e_valid"].sum()
    assert 0.6 < frac < 0.95
    # The blocked masks and the final gate in the problem's order agree.
    assert d["e_inlier"].sum() == d["e_inlier_orig"].sum()


def test_dist_ba_line_edges_match_single(runs):
    inp = runs[0]
    d, c = _ba_run(runs, "lines"), inp["ba"]["lines"]
    assert d["n_dropped"] == 0
    perr_d, perr_s = pose_errors(d["kf_T"], c["T_gt"]), pose_errors(d["single_kf_T"], c["T_gt"])
    assert perr_d[2:, :3].max() < 0.01, perr_d
    assert abs(perr_d.max() - perr_s.max()) < 0.005
    n_lines, axis = len(c["L0"]), c["axis"]
    for X in (d["pt_X"], d["single_pt_X"]):
        rel = X[60: 60 + n_lines] - c["L0"]
        perp = rel - (rel * axis).sum(1, keepdims=True) * axis
        assert np.median(np.linalg.norm(perp, axis=1)) < 0.02
    d_ep = np.linalg.norm(d["pt_X"][60: 60 + 2 * n_lines] - d["single_pt_X"][60: 60 + 2 * n_lines], axis=1)
    assert np.median(d_ep) < 0.01, np.median(d_ep)
    assert d["le_inlier"].sum() / d["le_valid"].sum() > 0.9
    # The pairs were co-located in the run.
    prob, blk = c["prob"], len(d["new_of_old"]) // WORLD
    assert (d["new_of_old"][prob["lp_s"]] // blk == d["new_of_old"][prob["lp_e"]] // blk).all()


def test_dist_ba_fixture_over_tcp_and_jax(runs):
    """The synthetic fixture's exact observations: the multi-process BA,
    joined through multihost.initialize, reaches the truth; the JAX
    package's 8-device run on the same problem agrees."""
    inp, _, ref = runs
    d, T_gt = _ba_run(runs, "fixture"), inp["ba"]["fixture"]["T_gt"]
    assert pose_errors(d["kf_T"], T_gt).max() < 1e-5
    assert pose_errors(ref["jax"]["ba_fixture"], T_gt).max() < 1e-5
    np.testing.assert_allclose(d["kf_T"], ref["jax"]["ba_fixture"], atol=1e-5, rtol=0)


# ---- pose LM, pose graph, global BA, database ----------------------------------


def test_dist_pose_step(runs):
    inp, ranks, ref = runs
    T_gt = torch.from_numpy(inp["lm"]["T_gt"])
    for run in ranks[0]["pose_step"]["runs"]:
        err = se3.log_se3(T_gt @ se3.inv(torch.from_numpy(run["T"]))).abs().max()
        assert err < 1e-5, (run["mesh"], float(err))
        np.testing.assert_allclose(run["T"], ranks[0]["pose_step"]["single_T"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(run["T"], ref["jax"]["lm"], atol=1e-5, rtol=0)
    assert [r["mesh"] for r in ranks[0]["pose_step"]["runs"]] == [{"seq": 2, "edge": 1}, {"seq": 1, "edge": 2}]


def test_dist_pose_graph_matches_single(runs):
    inp, ranks, ref = runs
    T, single = ranks[0]["pose_graph"]["T"], ranks[0]["pose_graph"]["single_T"]
    assert np.abs(T - single).max() < 1e-4, np.abs(T - single).max()
    assert np.abs(T - ref["jax"]["pg"]).max() < 1e-4
    T_gt, T0 = inp["pg"]["T_gt"], inp["pg"]["pg"]["T_cw"]
    err, err0 = np.abs(T[:, :3, 3] - T_gt[:, :3, 3]).max(), np.abs(T0[:, :3, 3] - T_gt[:, :3, 3]).max()
    assert err < 0.2 * err0 + 1e-4


@pytest.mark.parametrize("case", [0, 1], ids=["points", "line_edges"])
def test_dist_gba_matches_single(runs, case):
    inp, ranks, ref = runs
    d = ranks[0]["gba"]["runs"][case]
    assert np.abs(d["kf_T"] - d["single_kf_T"]).max() < 1e-4
    if case == 0:
        assert np.abs(d["kf_T"] - ref["jax"]["gba"]).max() < 1e-4
        assert np.abs(d["kf_T"][:, :3, 3] - inp["gba"]["T_gt"][:, :3, 3]).max() < 0.02
    assert np.isfinite(d["chi2"]) and np.isfinite(d["pt_X"]).all()
    E = inp["gba"]["probs"][case]["e_kf"].shape[0]
    assert d["e_inlier"].shape == (-(-E // WORLD) * WORLD,) and d["e_inlier"][:E].mean() > 0.9


def test_sharded_db_matches_dense(runs):
    _, ranks, ref = runs
    got = ranks[0]["db"]["runs"]
    for (ids_s, s_s), (ids_d, s_d), (ids_j, s_j) in zip(got[0]["results"], ref["db"][0], ref["jax"]["db"][0]):
        assert list(ids_s) == list(ids_d) == list(ids_j)
        np.testing.assert_allclose(s_s, s_d, atol=1e-5)
        np.testing.assert_allclose(s_s, s_j, atol=1e-5)
    for k, (ids, scores) in zip((0, 9, 19), got[1]["results"]):
        assert ids[0] == k and scores[0] > 0.999


# ---- across the ranks ------------------------------------------------------------


def _replicated(rank_out):
    out = {f"ba/{c}/{k}": rank_out["ba"]["runs"][i][k] for i, c in enumerate(BA_CASES)
           for k in ("kf_T", "pt_X_perm", "e_inlier", "le_inlier", "chi2")}
    out.update({f"lm/{i}": r["T"] for i, r in enumerate(rank_out["pose_step"]["runs"])})
    out["pg"] = rank_out["pose_graph"]["T"]
    out.update({f"gba/{i}/{k}": r[k] for i, r in enumerate(rank_out["gba"]["runs"])
                for k in ("kf_T", "pt_X", "chi2", "e_inlier", "le_inlier")})
    out.update({f"db/{i}/{j}": np.concatenate(q) for i, r in enumerate(rank_out["db"]["runs"])
                for j, q in enumerate(r["results"])})
    return out


def test_replicated_outputs_bit_equal_across_ranks(runs):
    a, b = (_replicated(r) for r in runs[1])
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_collectives_per_solve(runs):
    """The collectives each solve launched, as the modules document them
    (one identical-problem check: a broadcast and a sum)."""
    ranks = runs[1]
    n_lm = 5 + 10
    for r in ranks:
        for run in r["ba"]["runs"]:
            assert run["collectives"] == {"broadcast": 1, "psum": 1 + 2 * n_lm, "all_gather": 1 + n_lm + 1,
                                          "pmin": n_lm}
        assert r["pose_graph"]["collectives"] == {"broadcast": 1, "psum": 1 + PG_ITERS * (3 + 60)}
        for run in r["gba"]["runs"]:
            assert run["collectives"] == {"broadcast": 1, "psum": 1 + GBA_ITERS * (2 * 41 + 4) + 1,
                                          "all_gather": 2}
        (seq, edge) = r["pose_step"]["runs"]
        assert seq["collectives"] == {"all_gather": 1} and edge["collectives"] == {"psum": 2 * LM_ITERS}
        assert all(run["collectives"] == {"all_gather": len(q["queries"])}
                   for run, q in zip(r["db"]["runs"], runs[0]["dbs"]))


def test_ranks_with_different_problems_are_refused(runs):
    for r in runs[1]:
        assert r["mismatch"]["error"] is not None and "pt_X" in r["mismatch"]["error"]


def test_two_by_two_mesh(inputs, tmp_path):
    """Four ranks as a (2, 2) mesh, whose 'seq' and 'edge' sub-groups are
    new process groups: the pose LM with the sequences over 'seq' and the
    edges over 'edge', and the fixture's local BA over four ranks, each
    reaching the truth, the same on every rank."""
    lm = inputs["lm"]
    jobs = [("pose_step", dict(**{k: lm[k] for k in ("T0", "X", "obs", "w")}, intr=tuple(TCAM), n_iters=LM_ITERS,
                               n_seqs=[2])),
            ("ba", dict(probs=[inputs["ba"]["fixture"]["prob"]], intr=tuple(TCAM)))]
    ranks = dist_worker.run_ranks(jobs, 4, tmp_path, device="cpu", timeout_s=180)
    T_gt = torch.from_numpy(lm["T_gt"])
    for r in ranks:
        (run,) = r["pose_step"]["runs"]
        assert run["mesh"] == {"seq": 2, "edge": 2}
        assert run["collectives"] == {"psum": 2 * LM_ITERS, "all_gather": 1}
        assert se3.log_se3(T_gt @ se3.inv(torch.from_numpy(run["T"]))).abs().max() < 1e-5
        np.testing.assert_array_equal(run["T"], ranks[0]["pose_step"]["runs"][0]["T"])
        (ba,) = r["ba"]["runs"]
        assert pose_errors(ba["kf_T"], inputs["ba"]["fixture"]["T_gt"]).max() < 1e-5
        np.testing.assert_array_equal(ba["kf_T"], ranks[0]["ba"]["runs"][0]["kf_T"])
