"""Parity of the port's image ops with hfvo_tpu.ops.image on a rendered
120x160 frame. Filters and gathers are compared at 1e-4 (float32 sum
order of a few taps on [0, 255] values); pyramid levels at 5e-3, the gap
between XLA's fused float32 resize weights and the exact ones (each level
is resized from the previous one, so the gap is checked level by level)."""
import jax.numpy as jnp
import numpy as np
import pytest

from hfvo_tpu.ops import image as jimg
from hfvo_tpu_torch.ops import image as timg
from torch_helpers import small_frame, t

LEVELS = 4


def test_gaussian_kernel_equal():
    np.testing.assert_array_equal(
        timg.gaussian_kernel1d(2.0, 3), jimg.gaussian_kernel1d(2.0, 3)
    )


@pytest.mark.parametrize("sigma,radius", [(2.0, 3), (1.5, 2)])
def test_gaussian_blur(sigma, radius):
    g, _ = small_frame()
    want = np.asarray(jimg.gaussian_blur(jnp.asarray(g), sigma, radius))
    got = timg.gaussian_blur(t(g), sigma, radius).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("axis", [0, 1])
def test_sobel_gradients(axis):
    g, _ = small_frame()
    want = np.asarray(jimg.sobel_gradients(jnp.asarray(g))[axis])
    got = timg.sobel_gradients(t(g))[axis].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_maxpool2d_same():
    g, _ = small_frame()
    want = np.asarray(jimg.maxpool2d_same(jnp.asarray(g), 3))
    np.testing.assert_array_equal(timg.maxpool2d_same(t(g), 3).numpy(), want)


def test_extract_patches():
    g, _ = small_frame()
    rng = np.random.default_rng(3)
    yx = np.stack([rng.integers(-5, 125, 50), rng.integers(-5, 165, 50)], 1).astype(np.int32)
    want = np.asarray(jimg.extract_patches(jnp.asarray(g), jnp.asarray(yx), 15))
    got = timg.extract_patches(t(g), t(yx.astype(np.int64)), 15).numpy()
    np.testing.assert_array_equal(got, want)


def test_pyramid_shapes():
    assert timg.pyramid_shapes(480, 640, 8, 1.2) == jimg.pyramid_shapes(480, 640, 8, 1.2)


@pytest.mark.parametrize("level", range(LEVELS))
def test_build_pyramid_level(level):
    g, _ = small_frame()
    want = np.asarray(jimg.build_pyramid(jnp.asarray(g), LEVELS, 1.2)[level])
    got = timg.build_pyramid(t(g), LEVELS, 1.2)[level].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


@pytest.mark.parametrize("shape", [(100, 133), (240, 320)])
def test_resize_bilinear(shape):
    g, _ = small_frame()
    want = np.asarray(jimg.resize_bilinear(jnp.asarray(g), shape))
    got = timg.resize_bilinear(t(g), shape).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
