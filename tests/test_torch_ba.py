"""Local bundle adjustment (`solve/ba.py`) against hfvo_tpu's on the same
numpy problems (CPU), with two JAX compiles of `local_bundle_adjustment`:

- the JAX package's own fixture (`testing/ba_fixture.py`: 6 keyframes,
  80 points with exact stereo observations, poses 2.. and points
  perturbed);
- a problem with every edge kind: stereo and mono point edges, line-endpoint
  edges (one line exactly along the world x axis, whose endpoint blocks are
  near-singular along the line), line-axis pairs solved as 6-dof blocks,
  par/perp pairs and per-keyframe axis anchors, with one outlier
  observation.

Gates: poses within 0.1 mm and 0.01 deg, the same inlier masks, landmarks
within 1 mm. One LM step's blocks (Hpp, Hll, the pair cross block, U, b)
within 1e-4 of the largest entry, and its Schur solve within 1e-3 of the
largest step on the same inputs (the reduced system inherits the
near-singular endpoint blocks, which amplify float32 rounding of the
blocks tenfold; the full solves above still agree within the pose
tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.geometry import se3 as jse3
from hfvo_tpu.solve import ba as jba
from hfvo_tpu.testing.ba_fixture import synthetic_ba_problem
from hfvo_tpu_torch.config import tum3_config
from hfvo_tpu_torch.solve import ba as tba

JCAM = jax_tum3().camera
TCAM = tum3_config().camera
POSE_TOL_M, POSE_TOL_DEG = 1e-4, 0.01


def _to_port(prob) -> tba.BAProblem:
    def conv(v):
        if v is None:
            return None
        a = np.array(v)
        return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)

    return tba.BAProblem(*(conv(v) for v in prob))


def _pose_gap(Ta, Tb):
    D = Ta.astype(np.float64) @ np.linalg.inv(Tb.astype(np.float64))
    R = D[:3, :3]
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]), np.degrees(np.arctan2(s, 0.5 * (np.trace(R) - 1)))


def _lines_problem(seed=5):
    """5 keyframes (2 fixed), 60 points (40 stereo), 8 lines (two endpoint
    landmarks each, line 0 along the world x axis) observed by every
    keyframe, line-axis pairs for the 6 Manhattan lines, 4 par/perp pairs,
    axis anchors, and one gross outlier point observation."""
    rng = np.random.default_rng(seed)
    K, n_pts, n_lines = 5, 60, 8
    P, E, El, Lc, Lq = 96, 320, 96, 8, 8
    T_gt = np.stack([np.asarray(jse3.exp_se3(jnp.asarray(np.array(
        [0.12 * k, 0.02 * k, 0.0, 0.0, 0.03 * k, 0.0], np.float32)))) for k in range(K)])
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(3, 6, n_pts)], 1)
    axes = np.eye(3, dtype=np.float32)
    dirs = np.array([axes[0], axes[1], axes[2], axes[0], axes[1], axes[2],
                     [0.6, 0.8, 0.0], [0.0, 0.6, 0.8]], np.float32)
    L0 = np.stack([rng.uniform(-1.5, 0.5, n_lines), rng.uniform(-1, 1, n_lines), rng.uniform(3.5, 5, n_lines)], 1)
    L0[0] = [-1.0, 0.5, 4.0]
    L1 = L0 + dirs * rng.uniform(0.6, 1.0, (n_lines, 1))
    lm = np.concatenate([X, L0, L1]).astype(np.float32)
    e_kf, e_pt, e_obs = [], [], []
    le_kf, le_lm, le_l2d = [], [], []
    for k in range(K):
        R, t = T_gt[k, :3, :3], T_gt[k, :3, 3]
        Xc = X @ R.T + t
        u = JCAM.fx * Xc[:, 0] / Xc[:, 2] + JCAM.cx
        v = JCAM.fy * Xc[:, 1] / Xc[:, 2] + JCAM.cy
        ur = np.where(np.arange(n_pts) < 40, u - JCAM.bf / Xc[:, 2], -1.0)
        e_kf += [k] * n_pts
        e_pt += list(range(n_pts))
        e_obs += list(np.stack([u, v, ur], 1))
        for i in range(n_lines):
            h = []
            for Xe in (L0[i], L1[i]):
                c = R @ Xe + t
                h.append([JCAM.fx * c[0] / c[2] + JCAM.cx, JCAM.fy * c[1] / c[2] + JCAM.cy, 1.0])
            l2 = np.cross(h[0], h[1])
            l2 /= np.linalg.norm(l2[:2])
            for row in (n_pts + i, n_pts + n_lines + i):
                le_kf.append(k)
                le_lm.append(row)
                le_l2d.append(l2)
    e_obs = np.array(e_obs, np.float32)
    e_obs[7, :2] += 40.0  # one gross outlier
    ne, nle = len(e_kf), len(le_kf)

    def pad(a, n, dtype):
        out = np.zeros((n,) + np.asarray(a).shape[1:], dtype)
        out[: len(a)] = a
        return out

    T_init = T_gt.copy()
    for k in range(2, K):
        T_init[k] = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.01))) @ T_gt[k]
    lm_init = lm + rng.normal(size=lm.shape).astype(np.float32) * 0.01
    lp_valid = np.zeros(Lc, bool)
    lp_valid[:n_lines] = True
    lp_w = np.zeros(Lc, np.float32)
    lp_w[:6] = 100.0
    lp_axis = np.zeros((Lc, 3), np.float32)
    lp_axis[:6] = dirs[:6]
    ll = np.array([[0, 3, 0], [1, 4, 0], [0, 1, 1], [2, 5, 0]])  # (line a, line b, kind)
    axes_c = np.einsum("kij,aj->kai", T_gt[:, :3, :3], axes) + rng.normal(size=(K, 3, 3)).astype(np.float32) * 1e-3
    prob = jba.BAProblem(
        kf_T_cw=jnp.asarray(T_init.astype(np.float32)),
        kf_free=jnp.asarray(np.arange(K) >= 2),
        pt_X=jnp.asarray(pad(lm_init, P, np.float32)),
        pt_valid=jnp.asarray(pad(np.ones(len(lm), bool), P, bool)),
        e_kf=jnp.asarray(pad(e_kf, E, np.int32)), e_pt=jnp.asarray(pad(e_pt, E, np.int32)),
        e_obs=jnp.asarray(pad(e_obs, E, np.float32)),
        e_stereo=jnp.asarray(pad(e_obs[:, 2] > 0, E, bool)),
        e_inv_sigma2=jnp.asarray(pad(1.0 / 1.2 ** (2.0 * rng.integers(0, 3, ne)), E, np.float32)),
        e_valid=jnp.asarray(pad(np.ones(ne, bool), E, bool)),
        le_kf=jnp.asarray(pad(le_kf, El, np.int32)), le_lm=jnp.asarray(pad(le_lm, El, np.int32)),
        le_line2d=jnp.asarray(pad(np.array(le_l2d), El, np.float32)),
        le_inv_sigma2=jnp.asarray(pad(np.ones(nle), El, np.float32)),
        le_valid=jnp.asarray(pad(np.ones(nle, bool), El, bool)),
        lp_s=jnp.asarray(pad(n_pts + np.arange(n_lines), Lc, np.int32)),
        lp_e=jnp.asarray(pad(n_pts + n_lines + np.arange(n_lines), Lc, np.int32)),
        lp_axis=jnp.asarray(lp_axis), lp_w=jnp.asarray(lp_w), lp_valid=jnp.asarray(lp_valid),
        ll_sa=jnp.asarray(pad(n_pts + ll[:, 0], Lq, np.int32)),
        ll_ea=jnp.asarray(pad(n_pts + n_lines + ll[:, 0], Lq, np.int32)),
        ll_sb=jnp.asarray(pad(n_pts + ll[:, 1], Lq, np.int32)),
        ll_eb=jnp.asarray(pad(n_pts + n_lines + ll[:, 1], Lq, np.int32)),
        ll_kind=jnp.asarray(pad(ll[:, 2], Lq, np.int32)),
        ll_w=jnp.asarray(pad(np.full(len(ll), 50.0), Lq, np.float32)),
        ll_valid=jnp.asarray(pad(np.ones(len(ll), bool), Lq, bool)),
        kf_axes_c=jnp.asarray(axes_c.astype(np.float32)),
        kf_axes_w=jnp.asarray(axes),
        kf_w_axis=jnp.asarray(np.full((K, 3), 20.0, np.float32)),
    )
    return prob, T_gt, lm


@pytest.fixture(scope="module")
def lines_problem():
    return _lines_problem()


def _compare(want, got, T_gt, n_lm):
    Tj, Tt = np.asarray(want.kf_T_cw), got.kf_T_cw.numpy()
    for k in range(len(Tj)):
        dt, dr = _pose_gap(Tt[k], Tj[k])
        assert dt < POSE_TOL_M and dr < POSE_TOL_DEG, (k, dt, dr)
    np.testing.assert_array_equal(got.e_inlier.numpy(), np.asarray(want.e_inlier))
    np.testing.assert_array_equal(got.le_inlier.numpy(), np.asarray(want.le_inlier))
    np.testing.assert_allclose(got.pt_X.numpy()[:n_lm], np.asarray(want.pt_X)[:n_lm], atol=1e-3, rtol=0)
    # Both converge towards the ground truth.
    assert max(_pose_gap(Tt[k], T_gt[k])[0] for k in range(len(Tt))) < 2e-3


def test_ba_fixture_matches_jax():
    prob, T_gt = synthetic_ba_problem(JCAM, n_blocks=2, K=6, pts_per_block=40)
    want = jax.device_get(jba.local_bundle_adjustment(prob, JCAM))
    got = tba.local_bundle_adjustment(_to_port(prob), TCAM)
    _compare(want, got, T_gt, 80)
    assert got.e_inlier.all()


def test_ba_with_every_edge_kind_matches_jax(lines_problem):
    prob, T_gt, lm = lines_problem
    want = jax.device_get(jba.local_bundle_adjustment(prob, JCAM))
    got = tba.local_bundle_adjustment(_to_port(prob), TCAM)
    _compare(want, got, T_gt, len(lm))
    e_in = got.e_inlier.numpy()
    assert not e_in[7] and e_in[: 5 * 60].sum() == 5 * 60 - 1  # the outlier, demoted
    assert got.le_inlier.numpy()[: 5 * 16].all()
    # The axis-aligned line's endpoints stay on their line (no slide along
    # the near-null direction blows up) and the line stays on its axis.
    X = got.pt_X.numpy()
    for row in (60, 68):
        assert np.abs(X[row] - lm[row])[1:].max() < 0.02 and abs(X[row, 0] - lm[row, 0]) < 0.1
    d = X[68] - X[60]
    assert np.linalg.norm(np.cross(d / np.linalg.norm(d), [1.0, 0.0, 0.0])) < 0.01


def test_one_lm_step_blocks_and_solve_match_jax(lines_problem):
    prob, _, _ = lines_problem
    pp = _to_port(prob)
    th = np.where(np.asarray(prob.e_stereo), 7.815, 5.991).astype(np.float32)
    e_act = np.array(prob.e_valid)
    le_act = np.array(prob.le_valid)
    d_e, d_l = np.sqrt(th), np.sqrt(np.float32(3.84))
    build = jax.jit(lambda p, ea, la, de, dl: jba._build_blocks(p, p.kf_T_cw, p.pt_X, JCAM, ea, la, True, de, dl))
    want = build(prob, jnp.asarray(e_act), jnp.asarray(le_act), jnp.asarray(d_e), jnp.asarray(d_l))
    got = tba._build_blocks(pp, pp.kf_T_cw, pp.pt_X, TCAM, torch.from_numpy(e_act),
                            torch.from_numpy(le_act), True, torch.from_numpy(d_e), torch.tensor(d_l))
    for name, a, b in zip(("Hpp", "Hll", "Hx", "U", "bp", "bl", "chi2"), want, got):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_allclose(b, a, atol=1e-4 * np.abs(a).max(), rtol=0, err_msg=name)
    lam = np.float32(1e-4)
    dj = jax.jit(jba._schur_solve)(prob, *want[:6], jnp.asarray(lam))
    dt = tba._schur_solve(pp, *got[:6], torch.tensor(lam))
    for name, a, b in zip(("dpose", "dpt"), dj, dt):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_allclose(b, a, atol=1e-3 * np.abs(a).max(), rtol=0, err_msg=name)
