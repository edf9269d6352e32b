"""Parity of the port's se3/camera functions with hfvo_tpu.geometry on random
poses and points. Tolerance 1e-6 absolute (+1e-6 relative): float32
elementwise math in two frameworks, different transcendental and
small-matmul rounding only."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfvo_tpu.config import tum1_config as jax_tum1
from hfvo_tpu.geometry import camera as jcam
from hfvo_tpu.geometry import se3 as jse3
from hfvo_tpu_torch.config import tum1_config, tum3_config
from hfvo_tpu_torch.geometry import camera as tcam
from hfvo_tpu_torch.geometry import se3 as tse3
from torch_helpers import t

TOL = dict(atol=1e-6, rtol=1e-6)


def _inputs(seed=0, n=64):
    rng = np.random.default_rng(seed)
    xi = (rng.normal(size=(n, 6)) * np.array([0.5, 0.5, 0.5, 0.6, 0.6, 0.6])).astype(np.float32)
    xi[0, 3:] = 0.0  # identity rotation (series branch)
    xi[1, 3:] = np.array([2.9, 0.4, -0.2], np.float32)  # near pi
    w = xi[:, 3:]
    X = rng.uniform(-2, 2, (n, 3)).astype(np.float32) + np.array([0, 0, 4], np.float32)
    T = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    q = rng.normal(size=(n, 4)).astype(np.float32)
    M = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return dict(xi=xi, w=w, X=X, T=T, R=T[:, :3, :3], q=q, M=M)


CASES = {
    "hat": (lambda m: m.hat, ("w",)),
    "exp_so3": (lambda m: m.exp_so3, ("w",)),
    "log_so3": (lambda m: m.log_so3, ("R",)),
    "exp_se3": (lambda m: m.exp_se3, ("xi",)),
    "log_se3": (lambda m: m.log_se3, ("T",)),
    "inv": (lambda m: m.inv, ("T",)),
    "transform": (lambda m: m.transform, ("T", "X")),
    "rotate": (lambda m: m.rotate, ("T", "X")),
    "quat_from_mat": (lambda m: m.quat_from_mat, ("R",)),
    "mat_from_quat": (lambda m: m.mat_from_quat, ("q",)),
    "orthonormalize": (lambda m: m.orthonormalize, ("M",)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_se3_parity(name):
    fn, keys = CASES[name]
    inp = _inputs()
    want = np.asarray(fn(jse3)(*(jnp.asarray(inp[k]) for k in keys)))
    got = fn(tse3)(*(t(inp[k]) for k in keys)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_vee_inverts_hat():
    w = _inputs()["w"]
    np.testing.assert_allclose(tse3.vee(tse3.hat(t(w))).numpy(), w, atol=0)


def _cam_inputs(seed=1, n=200):
    rng = np.random.default_rng(seed)
    X = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(0.5, 6, n)], 1
    ).astype(np.float32)
    X[0, 2] = 0.0  # the 1e-9 depth guard
    uv = rng.uniform(-20, 660, (n, 2)).astype(np.float32)
    depth = rng.uniform(0.2, 6.0, n).astype(np.float32)
    return X, uv, depth


CAM_CASES = {
    "project": lambda m, i, X, uv, d: m.project(i, X),
    "project_stereo": lambda m, i, X, uv, d: m.project_stereo(i, X),
    "unproject": lambda m, i, X, uv, d: m.unproject(i, uv, d),
    "distort_normalized": lambda m, i, X, uv, d: m.distort_normalized(i, (uv - 320.0) / 520.0),
    "undistort_points": lambda m, i, X, uv, d: m.undistort_points(i, uv),
    "in_image": lambda m, i, X, uv, d: m.in_image(i, uv, margin=1.0),
}


@pytest.mark.parametrize("name", sorted(CAM_CASES))
def test_camera_parity(name):
    X, uv, d = _cam_inputs()
    fn = CAM_CASES[name]
    want = np.asarray(fn(jcam, jax_tum1().camera, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(d)))
    got = fn(tcam, tum1_config().camera, t(X), t(uv), t(d)).numpy()
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        # Pixel values reach ~1e11 at the 1e-9 depth guard; rtol covers them.
        np.testing.assert_allclose(got, want, **TOL)


def test_intrinsics_K_is_a_tensor():
    cam = tum3_config().camera
    K = cam.K
    assert isinstance(K, torch.Tensor) and K.dtype == torch.float32
    np.testing.assert_array_equal(K.numpy(), np.asarray(jcam.Intrinsics(*cam).K))
    assert tum1_config().camera.has_distortion and not cam.has_distortion
