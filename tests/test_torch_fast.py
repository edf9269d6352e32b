"""FAST: the plain version of kernel K1 against hfvo_tpu's jnp path and its
Pallas kernel (interpret mode), and the detector against hfvo_tpu's. The
CUDA kernel is held to its plain version in tests/test_torch_kernels.py.

Tolerances: corner sets (score > 0 and score > bonus) must be identical,
scores within atol 1e-4 (tests/test_pallas_fast.py's tolerance: float32
sum order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hfvo_tpu.ops import fast as jfast
from hfvo_tpu.ops.pallas_fast import fast_score_dual_pallas
from hfvo_tpu_torch.ops import fast as tfast
from torch_helpers import noise_image, small_frame, t

IMAGES = {"rendered": lambda: small_frame()[0], "noise_250x330": noise_image}


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
