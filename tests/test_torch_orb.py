"""ORB extraction, Hamming matching helpers and BoW words against hfvo_tpu.

extract_orb at 120x160 with 3 levels: level 0 must match exactly; levels
>= 1 must share >= 98% of keypoints (resize-weight rounding can move a
corner) and >= 95% of shared keypoints' descriptors must be identical
(a BRIEF bit flips where |v2 - v1| ~ 0). Hamming, best-2, the rotation
histogram and LSH words are integer computations and must agree exactly."""
import jax.numpy as jnp
import numpy as np
import pytest

from hfvo_tpu.bow import vocab as jvocab
from hfvo_tpu.config import OrbConfig as JOrbConfig
from hfvo_tpu.ops import hamming as jham
from hfvo_tpu.ops import orb as jorb
from hfvo_tpu_torch.bow import vocab as tvocab
from hfvo_tpu_torch.config import OrbConfig
from hfvo_tpu_torch.ops import hamming as tham
from hfvo_tpu_torch.ops import orb as torb
from torch_helpers import small_frame, t

ORB_KW = dict(n_features=300, n_levels=3)
CAP = 320


@pytest.fixture(scope="module")
def orb_pair():
    g = small_frame()[0]
    jf = jorb.extract_orb(jnp.asarray(g), JOrbConfig(**ORB_KW), CAP)
    tf = torb.extract_orb(t(g), OrbConfig(**ORB_KW), CAP)
    return {k: np.asarray(v) for k, v in jf._asdict().items()}, \
        {k: v.numpy() for k, v in tf._asdict().items()}


def _level(feats, level):
    m = (feats["octave"] == level) & feats["valid"]
    return {tuple(np.round(uv, 3)): i for i, uv in zip(np.nonzero(m)[0], feats["uv"][m])}


def test_level_budgets():
    for n, l in [(1000, 8), (300, 3), (37, 5)]:
        assert torb.level_budgets(n, l, 1.2) == jorb.level_budgets(n, l, 1.2)


def test_extract_orb_level0_exact(orb_pair):
    jf, tf = orb_pair
    m = jf["octave"] == 0
    for key in ("uv", "octave", "valid"):
        np.testing.assert_array_equal(tf[key][m], jf[key][m])
    np.testing.assert_array_equal(tf["desc"][m].astype(np.uint32), jf["desc"][m])
    np.testing.assert_allclose(tf["response"][m], jf["response"][m], atol=1e-4)
    np.testing.assert_allclose(tf["angle"][m], jf["angle"][m], atol=1e-4)
    assert jf["valid"][m].sum() > 20


@pytest.mark.parametrize("level", [1, 2])
def test_extract_orb_upper_levels(orb_pair, level):
    jf, tf = orb_pair
    js, ts = _level(jf, level), _level(tf, level)
    common = set(js) & set(ts)
    assert len(common) >= 0.98 * max(len(js), len(ts)) and len(common) > 5
    same = sum(
        np.array_equal(tf["desc"][ts[k]].astype(np.uint32), jf["desc"][js[k]]) for k in common
    )
    assert same >= 0.95 * len(common)


def _patches(seed=5, n=64):
    return np.random.default_rng(seed).uniform(0, 255, (n, 31, 31)).astype(np.float32)


def test_ic_angles():
    """atol 2e-4 rad: each moment sums ~700 products of up to 15 * 255 with
    heavy cancellation on noise patches, in a different float32 order."""
    p = _patches()
    np.testing.assert_allclose(
        torb.ic_angles_from_patches(t(p)).numpy(),
        np.asarray(jorb.ic_angles_from_patches(jnp.asarray(p))), atol=2e-4,
    )


def test_brief_from_patches_exact():
    """The gather form gives the bits of the JAX package's difference bank,
    over every rotation bin."""
    p = _patches(n=96)
    ang = np.linspace(-np.pi, np.pi, 96, endpoint=False).astype(np.float32) + 0.01
    want = np.asarray(jorb.brief_from_patches(jnp.asarray(p), jnp.asarray(ang)))
    got = torb.brief_from_patches(t(p), t(ang)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def _descs(seed, n):
    return np.random.default_rng(seed).integers(0, 2**32, (n, 8), dtype=np.uint32)


def test_hamming_matrix_exact():
    a, b = _descs(0, 70), _descs(1, 50)
    b[:5] = a[:5]
    want = np.asarray(jham.hamming_matrix_f(jnp.asarray(a), jnp.asarray(b)))
    got = tham.hamming_matrix_f(t(a.astype(np.int64)), t(b.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("density", [0.05, 0.5, 1.0])
def test_masked_best2_exact(density):
    rng = np.random.default_rng(2)
    dist = rng.integers(0, 20, (60, 40)).astype(np.float32)  # many ties
    mask = rng.uniform(size=dist.shape) < density
    want = [np.asarray(x) for x in jham.masked_best2(jnp.asarray(dist), jnp.asarray(mask))]
    got = [x.numpy() for x in tham.masked_best2(t(dist), t(mask))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_rotation_consistency_mask_exact():
    rng = np.random.default_rng(4)
    n = 300
    base = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    rot = np.where(rng.uniform(size=n) < 0.7, 0.3, rng.uniform(-3, 3, n)).astype(np.float32)
    a = base + rot
    ok = rng.uniform(size=n) < 0.8
    want = np.asarray(jham.rotation_consistency_mask(jnp.asarray(a), jnp.asarray(base), jnp.asarray(ok)))
    got = tham.rotation_consistency_mask(t(a), t(base), t(ok)).numpy()
    np.testing.assert_array_equal(got, want)


def test_compute_words_exact():
    d = _descs(9, 500)
    want = np.asarray(jvocab.compute_words(jnp.asarray(d)))
    got = tvocab.compute_words(t(d.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


def test_bow_histogram_np():
    rng = np.random.default_rng(1)
    w = rng.integers(0, 1024, 400)
    v = rng.uniform(size=400) < 0.7
    np.testing.assert_array_equal(tvocab.bow_histogram_np(w, v), jvocab.bow_histogram_np(w, v))
