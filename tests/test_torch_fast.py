"""FAST: the plain versions of kernels K1, K1b, K2 and K2b against
hfvo_tpu's jnp path and its Pallas kernels (interpret mode; the batched
ones under `jax.vmap`, which takes the kernels' batching rules to
`_dual_batched` and `_score_batched`), and the detector against hfvo_tpu's.
The CUDA kernels are held to their plain versions in
tests/test_torch_kernels.py.

Tolerances: corner sets (score > 0 and score > bonus) must be identical,
scores within atol 1e-4 (tests/test_pallas_fast.py's tolerance: float32
sum order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hfvo_tpu.ops import fast as jfast
from hfvo_tpu.ops.pallas_fast import fast_score_dual_pallas, fast_score_pallas
from hfvo_tpu_torch.ops import fast as tfast
from torch_helpers import noise_image, small_frame, small_frames, t

IMAGES = {"rendered": lambda: small_frame()[0], "noise_250x330": noise_image}
# Stacks for the batched kernels: 3 noise images of 250x330 (seeds 7-9) and
# 2 rendered frames of 120x160.
STACKS = {
    "noise_3x250x330": lambda: np.stack([noise_image(seed=s) for s in (7, 8, 9)]),
    "rendered_2x120x160": lambda: np.stack([g for g, _ in small_frames((2, 3))]),
}


@jax.jit
def _jax_dual_jit(img):
    s_lo = jfast.fast_score(img, 7.0)
    s_hi = jfast.fast_score(img, 20.0)
    return jnp.where(s_hi > 0, s_hi + 1e4, s_lo)


def _jax_dual(img):
    return np.asarray(_jax_dual_jit(jnp.asarray(img)))


def _assert_same_corners(got, want, atol=1e-4, rtol=0.0):
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_array_equal(got > 1e4, want > 1e4)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("image", sorted(IMAGES))
def test_dual_reference_matches_jnp(image):
    img = IMAGES[image]()
    got = tfast.fast_score_dual_reference(t(img), 7.0, 20.0).numpy()
    _assert_same_corners(got, _jax_dual(img))
    assert (got > 1e4).sum() > 50


@pytest.mark.parametrize("image", sorted(IMAGES))
def test_dual_reference_matches_pallas_interpret(image):
    img = IMAGES[image]()
    want = np.asarray(fast_score_dual_pallas(jnp.asarray(img), 7.0, 20.0, bonus=1e4,
                                             interpret=True))
    _assert_same_corners(tfast.fast_score_dual_reference(t(img), 7.0, 20.0).numpy(), want)


@pytest.mark.parametrize("threshold", [7.0, 15.0, 20.0])
def test_fast_score_single_threshold(threshold):
    img = noise_image()
    want = np.asarray(jax.jit(jfast.fast_score, static_argnums=1)(jnp.asarray(img), threshold))
    got = tfast.fast_score(t(img), threshold).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_cpu_wrapper_is_the_plain_version():
    img = t(noise_image(64, 80))
    before = tfast.fast_dual_launches
    out = tfast.fast_score_dual(img, 7.0, 20.0)
    assert tfast.fast_dual_launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(out.numpy(), tfast.fast_score_dual_reference(img, 7.0, 20.0).numpy())


def test_fast_nms():
    s = tfast.fast_score_dual_reference(t(small_frame()[0]), 7.0, 20.0).numpy()
    want = np.asarray(jfast.fast_nms(jnp.asarray(s)))
    np.testing.assert_array_equal(tfast.fast_nms(t(s)).numpy(), want)


def test_shi_tomasi_min_eig():
    g = small_frame()[0]
    want = np.asarray(jfast.shi_tomasi_min_eig(jnp.asarray(g)))
    got = tfast.shi_tomasi_min_eig(t(g)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-5)


@pytest.mark.parametrize("budget", [40, 200])
def test_detect_grid_topk_level0(budget):
    """Identical keypoint (y, x) sets and responses at level 0."""
    g = small_frame()[0]
    jyx, jresp, jvalid = (np.asarray(a) for a in jfast.detect_grid_topk(
        jnp.asarray(g), 20.0, 7.0, 16, budget, 19))
    tyx, tresp, tvalid = (a.numpy() for a in tfast.detect_grid_topk(
        t(g), 20.0, 7.0, 16, budget, 19))
    np.testing.assert_array_equal(tvalid, jvalid)
    np.testing.assert_array_equal(tyx[tvalid], jyx[jvalid])
    np.testing.assert_allclose(tresp, jresp, atol=1e-4)
    assert tvalid.sum() > 10


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_batched_dual_reference_matches_pallas_vmap(stack):
    """K1b: the port's plain version on (S, H, W) against the TPU kernel's
    batched launch (`_dual_batched`, interpret mode)."""
    imgs = STACKS[stack]()
    want = np.asarray(jax.vmap(
        lambda im: fast_score_dual_pallas(im, 7.0, 20.0, bonus=1e4, interpret=True)
    )(jnp.asarray(imgs)))
    got = tfast.fast_score_dual_reference(t(imgs), 7.0, 20.0).numpy()
    assert got.shape == imgs.shape
    _assert_same_corners(got, want)
    for i in range(len(imgs)):  # each image of the stack as alone
        np.testing.assert_array_equal(got[i], tfast.fast_score_dual_reference(t(imgs[i]), 7.0, 20.0).numpy())


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_single_threshold_reference_matches_pallas(stack):
    """K2 on each image and K2b on the stack (`_score_2d` and, under
    `jax.vmap`, `_score_batched`, interpret mode), at the two thresholds."""
    imgs = STACKS[stack]()
    for th in (7.0, 20.0):
        want_b = np.asarray(jax.vmap(lambda im: fast_score_pallas(im, th, interpret=True))(jnp.asarray(imgs)))
        got_b = tfast.fast_score_reference(t(imgs), th).numpy()
        np.testing.assert_array_equal(got_b > 0, want_b > 0)
        np.testing.assert_allclose(got_b, want_b, atol=1e-4, rtol=0)
        want_1 = np.asarray(fast_score_pallas(jnp.asarray(imgs[0]), th, interpret=True))
        got_1 = tfast.fast_score(t(imgs[0]), th).numpy()
        np.testing.assert_array_equal(got_1 > 0, want_1 > 0)
        np.testing.assert_allclose(got_1, want_1, atol=1e-4, rtol=0)


def test_cpu_wrappers_launch_nothing():
    """On the CPU every FAST wrapper, batched or not, is its plain version."""
    imgs = t(np.stack([noise_image(40, 56, seed=s) for s in (1, 2)]))
    counts = lambda: (tfast.fast_dual_launches, tfast.fast_dual_batched_launches,  # noqa: E731
                      tfast.fast_score_launches, tfast.fast_score_batched_launches)
    before = counts()
    np.testing.assert_array_equal(tfast.fast_score_dual(imgs, 7.0, 20.0).numpy(),
                                  tfast.fast_score_dual_reference(imgs, 7.0, 20.0).numpy())
    np.testing.assert_array_equal(tfast.fast_score(imgs, 7.0).numpy(),
                                  tfast.fast_score_reference(imgs, 7.0).numpy())
    levels = tfast.pyramid_fast_scores(imgs, 7.0, 20.0, n_levels=3)
    assert [tuple(x.shape) for x in levels[::2]] == [(2, 40, 56), (2, 33, 47), (2, 28, 39)]
    assert counts() == before


def test_detect_grid_topk_batched_equals_single():
    """The detector on a (2, H, W) stack returns each image's own keypoints."""
    imgs = np.stack([g for g, _ in small_frames((2, 3))])
    got = tfast.detect_grid_topk(t(imgs), 20.0, 7.0, 16, 120, 19)
    for i in range(2):
        one = tfast.detect_grid_topk(t(imgs[i]), 20.0, 7.0, 16, 120, 19)
        for a, b in zip(got, one):
            np.testing.assert_array_equal(a[i].numpy(), b.numpy())
