"""Point residuals and pose_optimization against hfvo_tpu's, on the scenes
of tests/test_pose_opt.py (clean, with outliers, all-invalid).

Every scene has N_EDGES edges, so the JAX side compiles its solver once.
Tolerance: final T_cw within 1e-5, identical inlier masks and n_inliers.
Both sides run the same visited (pose, lambda) sequence; they differ only
in float32 sum order of the 6x6 normal equations. The same holds with line
endpoint and line direction edges, read at prefixes of the sequence."""
import jax.numpy as jnp
import numpy as np
import pytest

from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.geometry import camera as jcam
from hfvo_tpu.geometry import se3 as jse3
from hfvo_tpu.solve import lm as jlm
from hfvo_tpu.solve import residuals as jres
from hfvo_tpu_torch.config import tum3_config
from hfvo_tpu_torch.solve import lm as tlm
from hfvo_tpu_torch.solve import residuals as tres
from torch_helpers import t

N_EDGES = 300
JINTR = jax_tum3().camera
TINTR = tum3_config().camera


def make_scene(rng, n=200, noise=0.0, outlier_frac=0.0):
    X_w = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2.0, 6.0, n)], axis=1
    ).astype(np.float32)
    xi = np.array([0.1, -0.05, 0.08, 0.04, -0.03, 0.06], np.float32)
    T_cw = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    X_c = np.asarray(jse3.transform(jnp.asarray(T_cw), jnp.asarray(X_w)))
    obs = np.array(jcam.project_stereo(JINTR, jnp.asarray(X_c)))
    obs[:, :2] += rng.normal(size=(n, 2)) * noise
    n_out = int(n * outlier_frac)
    if n_out:
        obs[:n_out, :2] += rng.uniform(20, 80, size=(n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return T_cw, X_w, obs.astype(np.float32), n_out


def _obs(X_w, obs, stereo, valid):
    n = len(X_w)
    is_st = np.full((n,), stereo) if np.isscalar(stereo) else stereo
    inv_s2 = np.ones((n,), np.float32)
    return (
        jlm.PoseObs(X_w=jnp.asarray(X_w), obs=jnp.asarray(obs), is_stereo=jnp.asarray(is_st),
                    inv_sigma2=jnp.asarray(inv_s2), valid=jnp.asarray(valid)),
        tlm.PoseObs(X_w=t(X_w), obs=t(obs), is_stereo=t(is_st), inv_sigma2=t(inv_s2),
                    valid=t(valid)),
    )


def _twist_pose(xi, T):
    return (np.asarray(jse3.exp_se3(jnp.asarray(np.asarray(xi, np.float32)))) @ T).astype(np.float32)


def _scene(name):
    rng = np.random.default_rng(0)
    if name == "clean_stereo":
        T, X, obs, _ = make_scene(rng, n=N_EDGES)
        return _twist_pose([0.05, -0.03, 0.02, 0.02, 0.01, -0.02], T), X, obs, True, np.ones(N_EDGES, bool)
    if name == "clean_mixed":
        T, X, obs, _ = make_scene(rng, n=N_EDGES, noise=0.3)
        stereo = rng.uniform(size=N_EDGES) < 0.5
        return _twist_pose([0.03, 0.02, -0.02, -0.01, 0.02, 0.01], T), X, obs, stereo, np.ones(N_EDGES, bool)
    if name == "outliers":
        T, X, obs, _ = make_scene(rng, n=N_EDGES, noise=0.5, outlier_frac=0.2)
        return _twist_pose([0.05, 0.02, -0.03, 0.01, -0.02, 0.02], T), X, obs, True, np.ones(N_EDGES, bool)
    if name == "all_invalid":
        z = np.zeros((N_EDGES, 3), np.float32)
        return np.eye(4, dtype=np.float32), z, z, True, np.zeros(N_EDGES, bool)
    raise KeyError(name)


@pytest.mark.parametrize("scene", ["clean_stereo", "clean_mixed", "outliers", "all_invalid"])
def test_pose_optimization_parity(scene):
    T0, X, obs, stereo, valid = _scene(scene)
    jp, tp = _obs(X, obs, stereo, valid)
    want = jlm.pose_optimization(jnp.asarray(T0), jp, JINTR)
    got = tlm.pose_optimization(t(T0), tp, TINTR)
    np.testing.assert_allclose(got.T_cw.numpy(), np.asarray(want.T_cw), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(want.inlier))
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-3, atol=1e-3)
    assert np.isfinite(got.T_cw.numpy()).all()


def _res_inputs():
    rng = np.random.default_rng(3)
    X = (rng.uniform(-1, 1, (40, 3)) + np.array([0, 0, 3])).astype(np.float32)
    obs = rng.uniform(0, 600, (40, 3)).astype(np.float32)
    T = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.1)))
    return T, X, obs


@pytest.mark.parametrize("part", [0, 1, 2])
def test_point_stereo_residual(part):
    T, X, obs = _res_inputs()
    want = np.asarray(jres.point_stereo_residual(jnp.asarray(T), jnp.asarray(X), jnp.asarray(obs), JINTR)[part])
    got = tres.point_stereo_residual(t(T), t(X), t(obs), TINTR)[part].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("part", [0, 1, 2])
def test_point_stereo_terms_t(part):
    T, X, obs = _res_inputs()
    want = np.asarray(jres.point_stereo_terms_t(jnp.asarray(T), jnp.asarray(X), jnp.asarray(obs), JINTR)[part])
    got = tres.point_stereo_terms_t(t(T), t(X), t(obs), TINTR)[part].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_out_of_slice_edges_raise():
    """The metric 3D point term (once refused, now ported) against the JAX
    package's on the outlier scene: depth-measured camera points with 1 cm
    noise, 10 % of them 0.3-1 m off, the 3D edges restricted to a
    `valid_3d` mask. Tolerance: T_cw within 1e-5, identical inliers."""
    T0, X, obs, stereo, valid = _scene("outliers")
    rng = np.random.default_rng(5)
    T_gt = _twist_pose(-np.array([0.05, 0.02, -0.03, 0.01, -0.02, 0.02]), T0)
    X_c = (X @ T_gt[:3, :3].T + T_gt[:3, 3] + rng.normal(size=X.shape) * 0.01).astype(np.float32)
    X_c[: N_EDGES // 10] += rng.uniform(0.3, 1.0, (N_EDGES // 10, 3)).astype(np.float32)
    valid_3d = rng.uniform(size=N_EDGES) < 0.8
    jp, tp = _obs(X, obs, stereo, valid)
    want = jlm.pose_optimization(jnp.asarray(T0), jp._replace(X_c_obs=jnp.asarray(X_c), valid_3d=jnp.asarray(valid_3d)),
                                 JINTR, inv_sigma2_3d=400.0)
    got = tlm.pose_optimization(t(T0), tp._replace(X_c_obs=t(X_c), valid_3d=t(valid_3d)), TINTR, inv_sigma2_3d=400.0)
    np.testing.assert_allclose(got.T_cw.numpy(), np.asarray(want.T_cw), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(want.inlier))
    np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-3, atol=1e-3)
    # The 3D edges are in the solve: its cost holds their chi2 besides the points'.
    alone = tlm.pose_optimization(t(T0), tp, TINTR)
    assert float(got.chi2) > float(alone.chi2) + 10.0


def _line_scene():
    """100 noisy mixed point edges, 40 map lines seen as 80 endpoint edges
    (4 of the lines mismatched), and 40 direction edges with random sign
    flips, 4 of them wrong; starting 5 cm / 3 deg off."""
    rng = np.random.default_rng(7)
    T, X, obs, _ = make_scene(rng, n=100, noise=0.5)
    stereo = rng.uniform(size=100) < 0.5
    L = 40
    A = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L), rng.uniform(2.5, 6, L)], 1)
    B = A + rng.normal(size=(L, 3)) * 0.6
    Xw = np.concatenate([A, B]).astype(np.float32)
    Xc = np.asarray(jse3.transform(jnp.asarray(T), jnp.asarray(Xw)))
    uv = np.array(jcam.project(JINTR, jnp.asarray(Xc)))
    q0, q1 = uv[:L], uv[L:]
    q1[:4] += 40.0  # mismatched lines
    h0 = np.concatenate([q0, np.ones((L, 1))], 1)
    h1 = np.concatenate([q1, np.ones((L, 1))], 1)
    l2 = np.cross(h0, h1)
    l2 /= np.linalg.norm(l2[:, :2], axis=1, keepdims=True)
    line2d = np.concatenate([l2, l2]).astype(np.float32)
    lvalid = np.ones(2 * L, bool)
    lvalid[L - 1] = lvalid[-1] = False
    dw = (B - A) / np.linalg.norm(B - A, axis=1, keepdims=True)
    dc = dw @ T[:3, :3].T + rng.normal(size=(L, 3)) * 0.01
    dc[:4] = rng.normal(size=(4, 3))
    dc /= np.linalg.norm(dc, axis=1, keepdims=True)
    dc *= rng.choice([-1.0, 1.0], (L, 1))
    dvalid = np.ones(L, bool)
    dvalid[5] = False
    T0 = _twist_pose([0.03, -0.02, 0.03, 0.03, -0.02, 0.03], T)
    return T0, X, obs, stereo, Xw, line2d, lvalid, dw.astype(np.float32), dc.astype(np.float32), dvalid


@pytest.mark.parametrize("n_rounds,n_iters", [(1, 2), (1, 4), (4, 10)])
def test_pose_optimization_with_lines_and_dirs(n_rounds, n_iters):
    """The same visited (pose, lambda) sequence, read at its prefixes: after
    2 and 4 iterations of the first round, and at the end; the same point
    and line inliers."""
    T0, X, obs, stereo, Xw, line2d, lvalid, dw, dc, dvalid = _line_scene()
    jp, tp = _obs(X, obs, stereo, np.ones(len(X), bool))
    ones_l = np.ones(len(Xw), np.float32)
    ones_d = np.ones(len(dw), np.float32)
    want = jlm.pose_optimization(
        jnp.asarray(T0), jp, JINTR,
        lines=jlm.LineObs(jnp.asarray(Xw), jnp.asarray(line2d), jnp.asarray(ones_l), jnp.asarray(lvalid)),
        dirs=jlm.DirObs(jnp.asarray(dw), jnp.asarray(dc), jnp.asarray(ones_d), jnp.asarray(dvalid)),
        n_rounds=n_rounds, n_iters=n_iters,
    )
    got = tlm.pose_optimization(
        t(T0), tp, TINTR,
        lines=tlm.LineObs(t(Xw), t(line2d), t(ones_l), t(lvalid)),
        dirs=tlm.DirObs(t(dw), t(dc), t(ones_d), t(dvalid)),
        n_rounds=n_rounds, n_iters=n_iters,
    )
    np.testing.assert_allclose(got.T_cw.numpy(), np.asarray(want.T_cw), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(want.inlier))
    np.testing.assert_array_equal(got.line_inlier.numpy(), np.asarray(want.line_inlier))
    np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-3, atol=1e-3)
    if n_rounds == 4:
        # The far endpoints of the mismatched lines are out (their near
        # endpoints lie on the wrong 2D line by construction).
        assert not got.line_inlier.numpy()[40:44].any()
        assert got.line_inlier.numpy().sum() >= 60


@pytest.mark.parametrize("part", [0, 1, 2])
def test_line_terms_t(part):
    T, X, obs = _res_inputs()
    l2 = np.random.default_rng(4).normal(size=(40, 3)).astype(np.float32)
    l2 /= np.linalg.norm(l2[:, :2], axis=1, keepdims=True)
    want = np.asarray(jres.line_terms_t(jnp.asarray(T), jnp.asarray(X), jnp.asarray(l2), JINTR)[part])
    got = tres.line_terms_t(t(T), t(X), t(l2), TINTR)[part].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    if part < 2:
        r_e, J_e, _ = tres.line_endpoint_residual(t(T), t(X), t(l2), TINTR)
        got_e = r_e[:, 0] if part == 0 else J_e[:, 0, :].T
        np.testing.assert_allclose(got_e.numpy(), got, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("part", [0, 1])
def test_dir_terms_t(part):
    T, X, _ = _res_inputs()
    dw = X / np.linalg.norm(X, axis=1, keepdims=True)
    dc = -dw[::-1].copy()
    want = np.asarray(jres.dir_terms_t(jnp.asarray(T), jnp.asarray(dw), jnp.asarray(dc))[part])
    got = tres.dir_terms_t(t(T), t(dw), t(dc))[part].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
