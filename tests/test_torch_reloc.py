"""Relocalization's solvers against hfvo_tpu's: Kabsch, the 3D-3D RANSAC,
PnP, the mutual descriptor matcher and the BoW histogram, on the scenes of
tests/test_reloc.py and tests/test_pnp.py.

The JAX package draws its RANSAC samples from a threefry stream
(`jax.random.choice` with `p = valid / sum`), which the port cannot
reproduce, so the port's solvers are split into a core that takes the
sample indices and a wrapper that draws them with `torch.multinomial`.
Here the cores are fed the JAX package's own draw (`jax_draw`, the draw
of hfvo_tpu/solve/ransac.py:89 and pnp.py:214), and held to:
- 3D-3D: T_ab within 1e-5, equal inlier masks, counts and decisions;
- PnP: the chosen pose within 1e-4 and equal inlier counts and decisions
  (its candidates come from batched eigh, whose null-vector signs and
  order within near-equal eigenvalues differ between LAPACK and XLA; the
  depth-sign and cheirality fixes make them comparable);
- the matcher and the histogram exactly, the L1 score within 1e-6.
The wrappers are held to the JAX tests' own statistical gates on the
port's draw, and the all-invalid input, where `torch.multinomial` would
refuse an all-zero row, declines without raising."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfvo_tpu.bow import vocab as jvocab
from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.geometry import camera as jcam
from hfvo_tpu.geometry import se3 as jse3
from hfvo_tpu.solve import pnp as jpnp
from hfvo_tpu.solve import ransac as jransac
from hfvo_tpu.tracking import matcher as jmatcher
from hfvo_tpu_torch.bow import vocab as tvocab
from hfvo_tpu_torch.config import tum3_config
from hfvo_tpu_torch.solve import pnp as tpnp
from hfvo_tpu_torch.solve import ransac as transac
from hfvo_tpu_torch.tracking import matcher as tmatcher
from torch_helpers import t

JINTR = jax_tum3().camera
TINTR = tum3_config().camera
N_PNP = 96  # every PnP scene has this many points, so JAX compiles pnp_ransac once


@partial(jax.jit, static_argnames=("n_hyp", "k"))
def _jax_draw_jit(seed, valid, n_hyp, k):
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    return jax.random.choice(jax.random.PRNGKey(seed), valid.shape[0], shape=(n_hyp, k), replace=True, p=p)


def jax_draw(valid, n_hyp: int, k: int, seed: int) -> torch.Tensor:
    """The JAX package's sample indices for `valid` (*B, N) as an int64
    tensor (*B, n_hyp, k): what `tracking`'s RANSAC calls draw there. Also
    the drop-in for the port's `draw_samples` in the slice tests."""
    v = np.asarray(valid.cpu() if hasattr(valid, "cpu") else valid)
    rows = [np.asarray(_jax_draw_jit(jnp.uint32(seed), jnp.asarray(r), n_hyp, k)) for r in v.reshape(-1, v.shape[-1])]
    out = np.stack(rows).reshape(v.shape[:-1] + (n_hyp, k)).astype(np.int64)
    return torch.from_numpy(out).to(valid.device if hasattr(valid, "device") else "cpu")


def _exp(xi):
    return np.asarray(jse3.exp_se3(jnp.asarray(np.asarray(xi, np.float32))))


# ---- Kabsch and the 3D-3D RANSAC -----------------------------------------


def test_kabsch_and_sim3_match_jax():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(30, 3)).astype(np.float32) * 2
    T_gt = _exp([0.2, -0.1, 0.3, 0.1, 0.2, -0.1])
    Y = (1.7 * (T_gt[:3, :3] @ X.T).T + T_gt[:3, 3]).astype(np.float32)
    w = rng.uniform(0.2, 1.0, 30).astype(np.float32)
    want = np.asarray(jax.jit(jransac.kabsch)(jnp.asarray(Y), jnp.asarray(X), jnp.asarray(w)))
    np.testing.assert_allclose(transac.kabsch(t(Y), t(X), t(w)).numpy(), want, atol=1e-5, rtol=0)
    s_j, T_j = jax.jit(jransac.kabsch_sim3)(jnp.asarray(Y), jnp.asarray(X), jnp.asarray(w))
    s_t, T_t = transac.kabsch_sim3(t(Y), t(X), t(w))
    assert abs(float(s_t) - float(s_j)) < 1e-5 and abs(float(s_t) - 1.7) < 1e-3
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5, rtol=0)


def _rigid_scene(name):
    rng = np.random.default_rng(0)
    n = 100
    X = rng.normal(size=(n, 3)).astype(np.float32) * 2
    T_gt = _exp([0.3, -0.2, 0.5, 0.2, 0.1, -0.3])
    Y = ((T_gt[:3, :3] @ X.T).T + T_gt[:3, 3]).astype(np.float32)
    valid = np.ones(n, bool)
    if name == "outliers":  # tests/test_reloc.py::test_ransac_3d3d_with_outliers
        Y[:30] += rng.uniform(0.5, 2.0, (30, 3)).astype(np.float32)
    elif name == "partial":  # outliers, and a third of the pairs invalid
        Y[:20] += rng.uniform(0.5, 2.0, (20, 3)).astype(np.float32)
        valid[rng.uniform(size=n) < 1 / 3] = False
    elif name == "collinear":  # most valid triples nearly collinear: the spread guard
        X[:80] = np.outer(np.linspace(-2, 2, 80), [1.0, 0.5, 0.2]).astype(np.float32)
        Y[:80] = ((T_gt[:3, :3] @ X[:80].T).T + T_gt[:3, 3]).astype(np.float32)
    elif name == "all_invalid":
        valid[:] = False
    return X, Y, valid, T_gt


@pytest.mark.parametrize("scene", ["outliers", "partial", "collinear", "all_invalid"])
def test_ransac_core_matches_jax_on_its_draw(scene):
    X, Y, valid, T_gt = _rigid_scene(scene)
    want = jransac.ransac_rigid_3d3d(jnp.asarray(Y), jnp.asarray(X), jnp.asarray(valid), jnp.uint32(3))
    idx = jax_draw(valid, transac.N_HYPOTHESES, 3, 3)
    got = transac.ransac_rigid_3d3d_core(t(Y), t(X), t(valid), idx)
    assert bool(got.ok) == bool(want.ok)
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    if scene == "all_invalid":
        assert not bool(got.ok) and int(got.n_inliers) == 0
        return
    np.testing.assert_allclose(got.T_ab.numpy(), np.asarray(want.T_ab), atol=1e-5, rtol=0)
    assert bool(got.ok)
    np.testing.assert_allclose(got.T_ab.numpy(), T_gt, atol=1e-3, rtol=0)


def test_ransac_wrapper_on_the_ports_draw():
    """The wrapper's own draw meets tests/test_reloc.py's gates; it draws
    only valid indices, the same ones for the same seed, and declines on an
    all-invalid input instead of raising."""
    X, Y, valid, T_gt = _rigid_scene("partial")
    idx = transac.draw_samples(t(valid), 128, 3, 5)
    assert idx.shape == (128, 3) and valid[idx.numpy()].all()
    assert torch.equal(idx, transac.draw_samples(t(valid), 128, 3, 5))
    # A batch element draws what it draws alone.
    both = transac.draw_samples(t(np.stack([valid, ~valid])), 128, 3, 5)
    assert torch.equal(both[0], idx)
    X, Y, valid, T_gt = _rigid_scene("outliers")
    res = transac.ransac_rigid_3d3d(t(Y), t(X), t(valid), 0)
    assert bool(res.ok) and int(res.n_inliers) >= 65
    assert np.abs(res.T_ab.numpy() - T_gt).max() < 0.01
    res = transac.ransac_rigid_3d3d(t(Y), t(X), t(np.zeros_like(valid)), 0)
    assert not bool(res.ok) and int(res.n_inliers) == 0


# ---- PnP ------------------------------------------------------------------


def _pnp_scene(name):
    """tests/test_pnp.py's scenes at N_PNP points: (X, uv, valid, T_gt, seed)."""
    rng = np.random.default_rng(0)
    n = N_PNP
    if name == "planar":
        X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), np.full(n, 4.0)], 1)
        xi = [0.15, -0.1, 0.1, 0.1, -0.05, 0.1]
    else:
        X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2.5, 6, n)], 1)
        xi = [0.2, -0.1, 0.15, 0.1, -0.08, 0.12]
    X = X.astype(np.float32)
    T = _exp(xi)
    uv = np.array(jcam.project(JINTR, jse3.transform(jnp.asarray(T), jnp.asarray(X))))
    valid = np.ones(n, bool)
    if name == "outliers":
        uv += rng.normal(size=uv.shape) * 0.5
        uv[:28] += rng.uniform(25, 120, (28, 2)) * rng.choice([-1, 1], (28, 2))
    if name == "degenerate":  # tests/test_pnp.py::test_pnp_degenerate_declines
        X[:] = [0.0, 0.0, 3.0]
        uv[:] = [320.0, 240.0]
        valid[:] = False
    seed = {"clean": 0, "outliers": 3, "planar": 1, "degenerate": 0}[name]
    return X, uv.astype(np.float32), valid, T, seed


@pytest.mark.parametrize("scene", ["clean", "outliers", "planar", "degenerate"])
def test_pnp_core_matches_jax_on_its_draw(scene):
    X, uv, valid, T_gt, seed = _pnp_scene(scene)
    want = jpnp.pnp_ransac(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), JINTR, jnp.uint32(seed))
    idx = jax_draw(valid, tpnp.N_HYP, tpnp.MIN_SET, seed)
    got = tpnp.pnp_ransac_core(t(X), t(uv), t(valid), TINTR, idx)
    assert bool(got.ok) == bool(want.ok)
    if scene == "degenerate":
        assert not bool(got.ok)
        return
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(got.T_cw.numpy(), np.asarray(want.T_cw), atol=1e-4, rtol=0)
    err = np.abs(np.asarray(jse3.log_se3(jnp.asarray(T_gt) @ jse3.inv(jnp.asarray(got.T_cw.numpy())))))
    assert err[:3].max() < (0.02 if scene == "outliers" else 5e-3), err


def test_pnp_pose_prior_joins_the_pool():
    """With a `T_init` hypothesis (relocalization passes the candidate
    keyframe's pose) the pool holds one more pose: on the planar scene both
    packages pick the same pose and inliers; on a draw with no valid set
    the prior alone carries the solve."""
    X, uv, valid, T_gt, seed = _pnp_scene("planar")
    T_init = _exp([0.003, 0.0, -0.003, 0.0, 0.002, 0.0]) @ T_gt
    want = jpnp.pnp_ransac(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), JINTR, jnp.uint32(seed),
                           T_init=jnp.asarray(T_init.astype(np.float32)))
    idx = jax_draw(valid, tpnp.N_HYP, tpnp.MIN_SET, seed)
    got = tpnp.pnp_ransac_core(t(X), t(uv), t(valid), TINTR, idx, T_init=t(T_init.astype(np.float32)))
    assert bool(got.ok) and int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(got.T_cw.numpy(), np.asarray(want.T_cw), atol=1e-4, rtol=0)
    # Every minimal set degenerate (all six samples one point): only the prior scores.
    same = torch.zeros((tpnp.N_HYP, tpnp.MIN_SET), dtype=torch.int64)
    alone = tpnp.pnp_ransac_core(t(X), t(uv), t(valid), TINTR, same, T_init=t(T_init.astype(np.float32)))
    assert bool(alone.ok) and np.abs(alone.T_cw.numpy() - T_gt).max() < 5e-3


def test_epnp_and_dlt_candidates_match_jax():
    """The candidates themselves, on noise-free minimal sets of 6: the DLT
    null vector is the smallest eigenvector of a rank-11 12x12 matrix in
    float32, whose direction LAPACK and XLA resolve only to ~1e-2 here, so
    the DLT poses agree within 2e-2 and each lies within 2e-2 of the truth;
    the best of the three EPnP cases recovers the pose within 1e-3 on both
    (tests/test_pnp.py::test_epnp_exact_general_scene)."""
    X, uv, valid, T_gt, _ = _pnp_scene("clean")
    f = np.array([JINTR.fx, JINTR.fy], np.float32)
    c = np.array([JINTR.cx, JINTR.cy], np.float32)
    xy = ((uv - c) / f).astype(np.float32)
    sets = np.arange(48).reshape(8, 6)
    Xs, xs = X[sets], xy[sets]
    want_e = np.asarray(jax.jit(jax.vmap(jpnp._epnp_pose))(jnp.asarray(Xs), jnp.asarray(xs)))
    want_d = np.asarray(jax.jit(jax.vmap(jpnp._dlt_pose))(jnp.asarray(Xs), jnp.asarray(xs)))
    got_e = tpnp._epnp_pose(t(Xs), t(xs)).numpy()
    got_d = tpnp._dlt_pose(t(Xs), t(xs)).numpy()
    assert got_e.shape == (8, 3, 4, 4) and np.isfinite(got_e).all()
    np.testing.assert_allclose(got_d, want_d, atol=2e-2, rtol=0)
    assert np.abs(got_d - T_gt).max() < 2e-2 and np.abs(want_d - T_gt).max() < 2e-2
    for cands in (got_e, want_e):
        assert max(min(np.abs(cands[s, k] - T_gt).max() for k in range(3)) for s in range(8)) < 1e-3


# ---- matching and BoW -------------------------------------------------------


def test_mutual_matching_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (280, 8), dtype=np.uint64).astype(np.uint32)
    # 150 planted near-duplicates (a few flipped bits), some ambiguous pairs.
    src = rng.choice(300, 150, replace=False)
    dst = rng.choice(280, 150, replace=False)
    b[dst] = a[src] ^ (rng.integers(0, 2, (150, 8)) << rng.integers(0, 32, (150, 8))).astype(np.uint32)
    b[dst[:10]] = a[src[0]]  # ten copies of one descriptor: not mutual
    va, vb = rng.uniform(size=300) < 0.9, rng.uniform(size=280) < 0.9
    idx_j, ok_j = jmatcher.match_descriptors_mutual(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb))
    idx_t, ok_t = tmatcher.match_descriptors_mutual(t(a.astype(np.int64)), t(va), t(b.astype(np.int64)), t(vb))
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    np.testing.assert_array_equal(idx_t.numpy()[ok_j], np.asarray(idx_j)[ok_j])
    assert 100 < ok_j.sum() < 150


def test_bow_histogram_and_score_match_jax():
    rng = np.random.default_rng(6)
    words = rng.integers(0, tvocab.N_WORDS, 500)
    valid = rng.uniform(size=500) < 0.8
    h_j = np.asarray(jvocab.bow_histogram(jnp.asarray(words.astype(np.int32)), jnp.asarray(valid)))
    h_t = tvocab.bow_histogram(t(words), t(valid)).numpy()
    np.testing.assert_array_equal(h_t, h_j)
    np.testing.assert_allclose(h_t, tvocab.bow_histogram_np(words, valid), atol=1e-7, rtol=0)
    h2 = tvocab.bow_histogram(t(words[::-1].copy()), t(valid)).numpy()
    want = float(jvocab.l1_score(jnp.asarray(h_j), jnp.asarray(h2)))
    assert abs(float(tvocab.l1_score(t(h_t), t(h2))) - want) < 1e-6
    assert float(tvocab.l1_score(t(h_t), t(h_t))) == 1.0
