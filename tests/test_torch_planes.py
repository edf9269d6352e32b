"""Planes: hfvo_tpu's plane segmentation, normals, plane association, plane
edges and the pose LM with plane and axis edges against the port's, on the
same seeded numpy inputs.

Tolerances:
- segment_planes: the same valid rows in the same order, normals within
  1e-4 rad (the angle from |n_a x n_b|), d within 1e-4 m, equal pixel
  counts; centroids within 1e-6 m and scatter within 1e-5 m^2. The block
  sums differ only in float32 summation order (a reshape-sum here, one-hot
  matmuls there), and the refit adds the same integer counts.
- compute_normals: the same validity mask, normals within 1e-6.
- match_planes: identical rows, kinds and counts.
- plane residuals and Jacobians: rtol 1e-5, atol 1e-6.
- pose_optimization with plane and axis edges: pose within 1e-5, identical
  point and plane inlier masks, chi2 within 1e-3 relative.
- A batch of S = 2 against two S = 1 calls of the port: within 1e-6, and
  the LM's pose within 1e-5 (its batched 6x6 sums round in another order;
  2.3e-6 measured).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.geometry import se3 as jse3
from hfvo_tpu.ops import planes as jp
from hfvo_tpu.solve import lm as jlm
from hfvo_tpu.solve import residuals as jres
from hfvo_tpu.tracking import matcher as jmatch
from hfvo_tpu_torch.config import tum3_config
from hfvo_tpu_torch.geometry import camera as tcam
from hfvo_tpu_torch.ops import planes as tp
from hfvo_tpu_torch.solve import lm as tlm
from hfvo_tpu_torch.solve import residuals as tres
from hfvo_tpu_torch.testing import synthetic
from hfvo_tpu_torch.tracking import matcher as tmatch
from torch_helpers import t

JCAM = jax_tum3().camera
TCAM = tum3_config().camera
ANG_TOL, D_TOL = 1e-4, 1e-4


def _look_at(position, target) -> np.ndarray:
    """T_wc of a camera at `position` looking at `target`, image y down
    (world +y)."""
    f = np.asarray(target, np.float64) - position
    f /= np.linalg.norm(f)
    x = np.cross([0.0, 1.0, 0.0], f)
    x /= np.linalg.norm(x)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.stack([x, np.cross(f, x), f], axis=1)
    T[:3, 3] = position
    return T


def _depths() -> dict:
    """The plane tests' 640x480 depth maps: tests/test_planes.py's single
    wall, two walls and noisy wall, and a rendered view of a room corner
    that sees the floor and two walls."""
    rng = np.random.default_rng(0)
    two = np.full((480, 640), 2.0, np.float32)
    two[:, 320:] = 4.0
    _, corner = synthetic.render(synthetic.make_room(0), TCAM,
                                 torch.from_numpy(_look_at([0.5, -0.2, 0.5], [3.0, 2.0, 3.0])))
    return {
        "wall": np.full((480, 640), 3.0, np.float32),
        "two_walls": two,
        "noisy": (2.5 + rng.normal(size=(480, 640)) * 0.004).astype(np.float32),
        "corner": corner.numpy(),
    }


@pytest.fixture(scope="module")
def depths():
    return _depths()


def _angles(na, nb):
    return np.arcsin(np.clip(np.linalg.norm(np.cross(na, nb), axis=-1), 0, 1))


def _assert_same_planes(got, want, what):
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v, err_msg=what)
    gp, wp = got.planes.numpy()[v], np.asarray(want.planes)[v]
    assert (np.sum(gp[:, :3] * wp[:, :3], axis=1) > 0).all(), what
    assert _angles(gp[:, :3], wp[:, :3]).max(initial=0) < ANG_TOL, what
    np.testing.assert_allclose(gp[:, 3], wp[:, 3], atol=D_TOL, rtol=0, err_msg=what)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts), err_msg=what)
    np.testing.assert_allclose(got.centroids.numpy()[v], np.asarray(want.centroids)[v], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.covs.numpy()[v], np.asarray(want.covs)[v], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.block_label.numpy(), np.asarray(want.block_label), err_msg=what)


@pytest.mark.parametrize("name,n_planes", [("wall", 1), ("two_walls", 2), ("noisy", 1), ("corner", 3)])
def test_segment_planes_matches_jax(depths, name, n_planes):
    d = depths[name]
    want = jp.segment_planes(jnp.asarray(d), JCAM)
    got = tp.segment_planes(t(d), TCAM)
    assert int(np.asarray(want.valid).sum()) == n_planes
    _assert_same_planes(got, want, name)


def test_segment_planes_ties_keep_label_order():
    """Two walls of equal support (equal counts): the lower label comes
    first, as jax.lax.top_k orders ties."""
    d = np.full((480, 640), 2.0, np.float32)
    d[:, 320:] = 3.0
    want = jp.segment_planes(jnp.asarray(d), JCAM)
    got = tp.segment_planes(t(d), TCAM)
    c = np.asarray(want.counts)
    assert c[0] == c[1] > 0
    _assert_same_planes(got, want, "equal counts")
    assert got.planes[0, 3] < got.planes[1, 3]  # the left (lower label) wall first


def test_near_tied_blocks_never_join_a_plane(depths):
    """eigh3's normal is rounding noise where the two smallest eigenvalues
    of a block's scatter tie. Holes without depth (zero scatter, an exact
    tie) and a patch at 1 mm depth (scatter at the 1e-10 floor) are cut into
    the corner view: in both packages no such block joins a plane, so the
    plane rows are unaffected. Every block that does join one has its
    smallest eigenvalue below half the middle one (float64)."""
    d = depths["corner"].copy()
    d[:48, :48] = 0.0
    d[96:128, 300:332] = 0.001
    want = jp.segment_planes(jnp.asarray(d), JCAM)
    got = tp.segment_planes(t(d), TCAM)
    _assert_same_planes(got, want, "corner with holes")
    B = tp.BLOCK
    cloud = tp.depth_to_cloud(t(d), TCAM).double().numpy()
    ok = d > 1e-3
    label = got.block_label.numpy()
    tied = []
    for by in range(label.shape[0]):
        for bx in range(label.shape[1]):
            c = cloud[by * B:(by + 1) * B, bx * B:(bx + 1) * B][ok[by * B:(by + 1) * B, bx * B:(bx + 1) * B]]
            w = np.linalg.eigvalsh(np.cov(c.T, bias=True)) if len(c) > 3 else np.zeros(3)
            if w[1] - w[0] <= 0.5 * w[1]:
                tied.append((by, bx))
                assert label[by, bx] < 0, (by, bx, w)
    assert len(tied) >= 9  # the hole's blocks at least


def test_segment_planes_batch_equals_single(depths):
    stack = np.stack([depths["corner"], depths["two_walls"]])
    both = tp.segment_planes(t(stack), TCAM)
    for s in range(2):
        one = tp.segment_planes(t(stack[s]), TCAM)
        for a, b in zip(both, one):
            np.testing.assert_allclose(a[s].numpy(), b.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("stride", [4, 8])
def test_compute_normals_matches_jax(depths, stride):
    d = depths["corner"]
    n_j, ok_j = jp.compute_normals(jnp.asarray(d), JCAM, stride=stride)
    n_t, ok_t = tp.compute_normals(t(d), TCAM, stride=stride)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-6, rtol=0)


def test_compute_normals_wraps_around():
    """The validity of a sample in row 0 reads the last sampled row (the
    JAX package's jnp.roll): with the last rows without depth, row 0 is
    invalid in both packages, and so is column 0 with the last columns."""
    d = np.full((480, 640), 2.0, np.float32)
    d[-8:, :] = 0.0
    d[:, -8:] = 0.0
    ok_j = np.asarray(jp.compute_normals(jnp.asarray(d), JCAM, stride=8)[1]).reshape(60, 80)
    ok_t = tp.compute_normals(t(d), TCAM, stride=8)[1].numpy().reshape(60, 80)
    np.testing.assert_array_equal(ok_t, ok_j)
    assert not ok_t[0].any() and not ok_t[:, 0].any() and ok_t[1:-2, 1:-2].all()
    stack = tp.compute_normals(t(np.stack([d, np.full_like(d, 3.0)])), TCAM, stride=8)[1]
    np.testing.assert_array_equal(stack[0].numpy().reshape(60, 80), ok_t)


def _plane_scene(seed: int = 5):
    """A pose, 12 valid map planes among 40 slots, and 32 observed planes:
    8 seen noisily through the pose, 6 parallel and 6 perpendicular to map
    planes at other offsets, 6 random, 6 invalid rows."""
    rng = np.random.default_rng(seed)
    T = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.2)))
    Q, P = 40, 32
    n_w = rng.normal(size=(Q, 3))
    n_w /= np.linalg.norm(n_w, axis=1, keepdims=True)
    mp = np.concatenate([n_w, rng.uniform(-3, 3, (Q, 1))], axis=1).astype(np.float32)
    mp_valid = np.zeros(Q, bool)
    mp_valid[rng.choice(Q, 12, replace=False)] = True
    vidx = np.nonzero(mp_valid)[0]
    R, tt = T[:3, :3], T[:3, 3]
    obs = np.zeros((P, 4), np.float32)
    cent = rng.uniform(-2, 2, (P, 3)).astype(np.float32)
    for i in range(P):
        q = vidx[i % len(vidx)]
        n_c = R @ mp[q, :3]
        if i < 8:
            n_o = n_c + rng.normal(size=3) * 0.02
            n_o /= np.linalg.norm(n_o)
            d_o = mp[q, 3] - tt @ n_c + rng.normal() * 0.02
            cent[i] = -d_o * n_o + np.cross(n_o, rng.normal(size=3)) * 0.5
        elif i < 14:
            n_o, d_o = -n_c, rng.uniform(-3, 3)
        elif i < 20:
            n_o = np.cross(n_c, rng.normal(size=3))
            n_o /= np.linalg.norm(n_o)
            d_o = rng.uniform(-3, 3)
        else:
            n_o = rng.normal(size=3)
            n_o /= np.linalg.norm(n_o)
            d_o = rng.uniform(-3, 3)
        obs[i] = np.append(n_o, d_o)
    obs_valid = np.ones(P, bool)
    obs_valid[26:] = False
    return T.astype(np.float32), mp, mp_valid, obs, cent, obs_valid


def test_match_planes_matches_jax():
    T, mp, mpv, obs, cent, ov = _plane_scene()
    want = jmatch.match_planes(jnp.asarray(mp), jnp.asarray(mpv), jnp.asarray(obs), jnp.asarray(cent),
                               jnp.asarray(ov), jnp.asarray(T))
    got = tmatch.match_planes(t(mp), t(mpv), t(obs), t(cent), t(ov), t(T))
    np.testing.assert_array_equal(got.map_idx.numpy(), np.asarray(want.map_idx))
    np.testing.assert_array_equal(got.kind.numpy(), np.asarray(want.kind))
    assert int(got.n_matches) == int(want.n_matches) >= 6
    assert set(got.kind.numpy().tolist()) == {-1, 0, 1, 2}
    both = tmatch.match_planes(*(torch.stack([t(a), t(b)]) for a, b in zip(
        (mp, mpv, obs, cent, ov, T), _plane_scene(6)[1:] + _plane_scene(6)[:1])))
    np.testing.assert_array_equal(both.kind[0].numpy(), got.kind.numpy())
    other = tmatch.match_planes(*(t(a) for a in _plane_scene(6)[1:] + _plane_scene(6)[:1]))
    np.testing.assert_array_equal(both.map_idx[1].numpy(), other.map_idx.numpy())


def _edge_inputs():
    T, mp, _, obs, _, _ = _plane_scene(7)
    kind = np.resize(np.array([0, 1, 2, 0], np.int32), len(obs))
    return T, mp[: len(obs)], obs, kind


@pytest.mark.parametrize("fn,n_out", [("plane_edge_terms_t", 3), ("plane_edge_terms", 3),
                                      ("plane_residual", 2)])
def test_plane_edges_match_jax(fn, n_out):
    T, pi_w, obs, kind = _edge_inputs()
    jargs = (jnp.asarray(T), jnp.asarray(pi_w)) + (() if fn == "plane_residual" else (jnp.asarray(obs), jnp.asarray(kind)))
    targs = (t(T), t(pi_w)) + (() if fn == "plane_residual" else (t(obs), t(kind)))
    want = getattr(jres, fn)(*jargs)
    got = getattr(tres, fn)(*targs)
    assert len(got) == n_out
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    if fn == "plane_edge_terms_t":
        # The edge-axis-last layout holds the same terms as plane_edge_terms,
        # and a batch of 2 poses equals two single calls.
        r, J, comp = tres.plane_edge_terms(*targs)
        np.testing.assert_allclose(got[0].numpy(), r.numpy().T, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), J.numpy().transpose(1, 2, 0), rtol=1e-5, atol=1e-6)
        T2 = np.stack([T, np.eye(4, dtype=np.float32)])
        both = tres.plane_edge_terms_t(t(T2), *(torch.stack([a, a]) for a in targs[1:]))
        one = tres.plane_edge_terms_t(t(T2[1]), *targs[1:])
        for a, b in zip(both, one):
            np.testing.assert_allclose(a[1].numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_plane_minimal_error_matches_jax():
    _, pi_w, obs, _ = _edge_inputs()
    want = jres.plane_minimal_error(jnp.asarray(obs), jnp.asarray(pi_w))
    got = tres.plane_minimal_error(t(obs), t(pi_w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert np.abs(got.numpy()[:, 0]).max() <= np.pi


def _lm_scene():
    """150 noisy stereo point edges, 10 plane edges (6 full, 2 parallel, 2
    vertical; one full edge 1.2 m off) and 3 axis anchors (one switched
    off), starting 4 cm / 2.5 deg off."""
    rng = np.random.default_rng(11)
    n = 150
    X_w = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2.0, 6.0, n)], 1).astype(np.float32)
    T = np.asarray(jse3.exp_se3(jnp.asarray(np.array([0.1, -0.05, 0.08, 0.04, -0.03, 0.06], np.float32))))
    X_c = X_w @ T[:3, :3].T + T[:3, 3]
    obs = np.stack([TCAM.fx * X_c[:, 0] / X_c[:, 2] + TCAM.cx, TCAM.fy * X_c[:, 1] / X_c[:, 2] + TCAM.cy], 1)
    obs = np.concatenate([obs, obs[:, :1] - TCAM.bf / X_c[:, 2:]], 1) + rng.normal(size=(n, 3)) * 0.4
    axes_w = np.asarray(jse3.exp_so3(jnp.asarray(np.array([0.2, -0.4, 0.1], np.float32))))
    n_w = np.concatenate([axes_w, -axes_w, axes_w, axes_w[:1]])[:10]
    pi_w = np.concatenate([n_w, rng.uniform(-3, -1, (10, 1))], 1).astype(np.float32)
    n_c = n_w @ T[:3, :3].T
    d_c = pi_w[:, 3] - n_c @ T[:3, 3]
    kind = np.array([0, 0, 0, 0, 0, 0, 1, 1, 2, 2], np.int32)
    pi_obs = np.concatenate([n_c + rng.normal(size=(10, 3)) * 0.005, d_c[:, None] + 0.003], 1)
    pi_obs[8:, :3] = np.cross(n_c[8:], rng.normal(size=(2, 3)))
    pi_obs[:, :3] /= np.linalg.norm(pi_obs[:, :3], axis=1, keepdims=True)
    pi_obs[6:, 3] = rng.uniform(-3, 3, 4)
    pi_obs[5, 3] += 1.2
    weight = np.where((kind == 0)[:, None], [[0.5, 0.5, 100.0]], [[0.5, 0.0, 0.0]]).astype(np.float32)
    chi2_th = np.where(kind == 0, 100.0, 50.0).astype(np.float32)
    axes_c = (axes_w @ T[:3, :3].T + rng.normal(size=(3, 3)) * 0.002).astype(np.float32)
    w_axis = np.array([1e5, 5e4, 0.0], np.float32)
    T0 = (np.asarray(jse3.exp_se3(jnp.asarray(np.array([0.03, -0.02, 0.02, 0.03, -0.02, 0.02], np.float32)))) @ T)
    return (T0.astype(np.float32), X_w, obs.astype(np.float32), pi_w, pi_obs.astype(np.float32), kind, weight,
            chi2_th, np.ones(10, bool), axes_c, axes_w.astype(np.float32), w_axis)


def _lm_obs(mod, conv, scene):
    T0, X_w, obs, pi_w, pi_obs, kind, weight, chi2_th, pvalid, axes_c, axes_w, w_axis = scene
    n = len(X_w)
    pts = mod.PoseObs(X_w=conv(X_w), obs=conv(obs), is_stereo=conv(np.ones(n, bool)),
                      inv_sigma2=conv(np.ones(n, np.float32)), valid=conv(np.ones(n, bool)))
    planes = mod.PlaneObs(conv(pi_w), conv(pi_obs), conv(kind), conv(weight), conv(chi2_th), conv(pvalid))
    return conv(T0), pts, planes, conv(axes_c), conv(axes_w), conv(w_axis)


def test_pose_optimization_with_planes_and_axes():
    scene = _lm_scene()
    T0, pts, planes, ac, aw, wa = _lm_obs(jlm, jnp.asarray, scene)
    want = jlm.pose_optimization(T0, pts, JCAM, planes=planes, axes_c=ac, axes_w=aw, w_axis=wa)
    T0, pts, planes, ac, aw, wa = _lm_obs(tlm, t, scene)
    got = tlm.pose_optimization(T0, pts, TCAM, planes=planes, axes_c=ac, axes_w=aw, w_axis=wa)
    np.testing.assert_allclose(got.T_cw.numpy(), np.asarray(want.T_cw), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(want.inlier))
    np.testing.assert_array_equal(got.plane_inlier.numpy(), np.asarray(want.plane_inlier))
    np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-3)
    assert not got.plane_inlier[5] and got.plane_inlier.sum() >= 7
    # A batch of 2 (the scene and the scene from the identity) against two
    # single solves.
    T_id = t(np.eye(4, dtype=np.float32))
    batch = tlm.pose_optimization(
        torch.stack([T0, T_id]), tlm.PoseObs(*(torch.stack([a, a]) for a in pts[:5])), TCAM,
        planes=tlm.PlaneObs(*(torch.stack([a, a]) for a in planes)),
        axes_c=torch.stack([ac, ac]), axes_w=torch.stack([aw, aw]), w_axis=torch.stack([wa, wa]),
    )
    alone = tlm.pose_optimization(T_id, pts, TCAM, planes=planes, axes_c=ac, axes_w=aw, w_axis=wa)
    np.testing.assert_allclose(batch.T_cw[0].numpy(), got.T_cw.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(batch.T_cw[1].numpy(), alone.T_cw.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(batch.plane_inlier[1].numpy(), alone.plane_inlier.numpy())


def test_plane_projection_helpers_agree(depths):
    """depth_to_cloud reprojects onto the pixel grid through the camera
    model, batched or not."""
    d = t(depths["corner"])
    cloud = tp.depth_to_cloud(torch.stack([d, d]), TCAM)
    uv = tcam.project(TCAM, cloud[0].reshape(-1, 3))
    yy, xx = np.mgrid[:480, :640]
    np.testing.assert_allclose(uv.numpy(), np.stack([xx.ravel(), yy.ravel()], 1), atol=2e-3)
    np.testing.assert_array_equal(cloud[1].numpy(), cloud[0].numpy())
