"""The keyframe path's triangulation and its building blocks against
hfvo_tpu's on the same seeded numpy inputs (CPU).

- `eigh4`: eigenvalues within 1e-5 relative and eigenvectors (same sign:
  both run the same Jacobi sweeps from the identity) within 1e-5 where the
  eigenvalue is separated from the others. `inv3x3` within 1e-5 relative.
- `hamming_matrix` equal; `mutual_best` equal, ties included: on a tie both
  keep the lowest index.
- `triangulate_multi` (two neighbour keyframes, one batched call; and
  `triangulate_pair` on one of them against its row of the batch: the same
  masks and matches, X within 1e-5 m) on keypoints projected from seeded 3D
  points with descriptor noise and distractors: the accepted masks differ
  in at most 1 % of the candidates (matches that sit on the epipolar or
  chi2 gates may fall either way by rounding); where both accept, the same
  match and X within 1 mm.
- `triangulate_lines_pair` on seeded 3D segments seen by three keyframes:
  the same 1 % and 1 mm tolerances on both endpoints.
"""
import jax.numpy as jnp
import numpy as np

from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.geometry import se3 as jse3
from hfvo_tpu.ops import hamming as jham
from hfvo_tpu.ops import sym_eig as jeig
from hfvo_tpu.ops import triangulate as jtri
from hfvo_tpu_torch.config import tum3_config
from hfvo_tpu_torch.ops import hamming as tham
from hfvo_tpu_torch.ops import sym_eig as teig
from hfvo_tpu_torch.ops import triangulate as ttri
from torch_helpers import t

JCAM = jax_tum3().camera
TCAM = tum3_config().camera
MASK_ALLOWANCE = 0.01  # share of candidates whose accept flag may differ
X_TOL_M = 1e-3


def test_eigh4_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(64, 4, 4)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1)
    A[0] = 0.0
    A[1] = np.diag([1e-12, 1e-12, 1e-12, 1e-12])
    # A rank-3 DLT-like block: a clean null vector.
    B = rng.normal(size=(3, 4)).astype(np.float32)
    A[2] = B.T @ B
    wj, Vj = (np.asarray(x) for x in jeig.eigh4(jnp.asarray(A)))
    wt, Vt = (x.numpy() for x in teig.eigh4(t(A)))
    np.testing.assert_allclose(wt, wj, rtol=1e-5, atol=1e-5 * np.abs(wj).max())
    for i in range(len(A)):
        for k in range(4):
            gap = np.min(np.abs(np.delete(wj[i], k) - wj[i, k]))
            if gap > 1e-3 * max(np.abs(wj[i]).max(), 1e-12):
                np.testing.assert_allclose(Vt[i, :, k], Vj[i, :, k], atol=1e-5, err_msg=f"{i}, {k}")
    # The null vector of the rank-3 block.
    assert np.abs(B @ Vt[2, :, 0]).max() < 1e-4


def test_inv3x3_matches_jax():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(128, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    A[0] = 0.0  # the 1e-30 guard: finite
    want = np.asarray(jeig.inv3x3(jnp.asarray(A)))
    got = teig.inv3x3(t(A)).numpy()
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5, atol=1e-6)
    assert np.isfinite(got[0]).all() and np.array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1:] @ A[1:], np.broadcast_to(np.eye(3), (127, 3, 3)), atol=1e-3)


def test_hamming_matrix_and_mutual_best_match_jax():
    rng = np.random.default_rng(2)
    da = rng.integers(0, 2**32, (40, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, (50, 8), dtype=np.uint32)
    db[:20] = da[:20] ^ np.uint32(0b1011)  # near copies
    Dj = np.asarray(jham.hamming_matrix(jnp.asarray(da), jnp.asarray(db)))
    Dt = tham.hamming_matrix(t(da.astype(np.int64)), t(db.astype(np.int64))).numpy()
    np.testing.assert_array_equal(Dt, Dj)
    mask = rng.uniform(size=Dj.shape) > 0.2
    bj, okj = (np.asarray(x) for x in jham.mutual_best(jnp.asarray(Dj), jnp.asarray(mask)))
    bt, okt = (x.numpy() for x in tham.mutual_best(t(Dj), t(mask)))
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(okt, okj)
    assert okt.sum() >= 10


def test_mutual_best_ties_go_to_the_lowest_index():
    D = np.full((4, 5), 100, np.int32)
    D[0, 1] = D[0, 3] = 5  # row 0: tie between columns 1 and 3
    D[2, 1] = 5  # column 1: tie between rows 0 and 2
    D[3, 4] = D[3, 2] = 7
    D[1, 4] = 7  # column 4: rows 1 and 3 tie
    mask = np.ones_like(D, bool)
    mask[1, 0] = False
    bj, okj = (np.asarray(x) for x in jham.mutual_best(jnp.asarray(D), jnp.asarray(mask)))
    bt, okt = (x.numpy() for x in tham.mutual_best(t(D), t(mask)))
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(okt, okj)
    assert bt[0] == 1 and okt[0]  # lowest column; column 1's lowest row is 0
    assert not okt[2]  # column 1 went to row 0
    assert bt[3] == 2 and okt[3]


def _pose(rng, t_scale=0.3, r_scale=0.08):
    xi = np.concatenate([rng.normal(size=3) * t_scale, rng.normal(size=3) * r_scale]).astype(np.float32)
    return np.asarray(jse3.exp_se3(jnp.asarray(xi)))


def _project(T, X):
    Xc = X @ T[:3, :3].T + T[:3, 3]
    return np.stack([JCAM.fx * Xc[:, 0] / Xc[:, 2] + JCAM.cx, JCAM.fy * Xc[:, 1] / Xc[:, 2] + JCAM.cy], 1), Xc[:, 2]


def _point_scene(seed=3, C=256, n_nb=2):
    """Keyframe a at the origin and `n_nb` neighbours seeing the same 3D
    points: a's keypoints (with 0.3 px noise and random octaves), each
    neighbour's a shuffled copy with a few descriptor bits flipped, plus
    distractors and non-candidates."""
    rng = np.random.default_rng(seed)
    n_pts = 200
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(2, 7, n_pts)], 1)
    uv_a = np.zeros((C, 2), np.float32)
    uv_a[:n_pts] = _project(np.eye(4), X)[0] + rng.normal(size=(n_pts, 2)) * 0.3
    uv_a[n_pts:] = rng.uniform([0, 0], [640, 480], (C - n_pts, 2))
    desc_a = rng.integers(0, 2**32, (C, 8), dtype=np.uint32)
    oct_a = rng.integers(0, 3, C).astype(np.int32)
    cand_a = rng.uniform(size=C) > 0.1
    uv_b = np.zeros((n_nb, C, 2), np.float32)
    desc_b = rng.integers(0, 2**32, (n_nb, C, 8), dtype=np.uint32)
    oct_b = rng.integers(0, 3, (n_nb, C)).astype(np.int32)
    cand_b = rng.uniform(size=(n_nb, C)) > 0.1
    T_ab = np.zeros((n_nb, 4, 4), np.float32)
    for j in range(n_nb):
        T_b = _pose(rng)  # b-camera <- world (= a-camera)
        perm = rng.permutation(C)
        uv, z = _project(T_b, X)
        rows = perm[:n_pts]
        uv_b[j, rows] = uv + rng.normal(size=(n_pts, 2)) * 0.3
        uv_b[j, perm[n_pts:]] = rng.uniform([0, 0], [640, 480], (C - n_pts, 2))
        flips = rng.integers(0, 2**6, (n_pts, 8), dtype=np.uint32)
        desc_b[j, rows] = desc_a[:n_pts] ^ flips
        oct_b[j, rows] = np.clip(oct_a[:n_pts] + rng.integers(-1, 2, n_pts), 0, 7)
        T_ab[j] = np.linalg.inv(T_b)
    return uv_a, desc_a, cand_a, oct_a, uv_b, desc_b, cand_b, oct_b, T_ab


def _compare_points(want, got, n_cand):
    X_j, m_j, ok_j = (np.asarray(x) for x in want)
    X_t, m_t, ok_t = (x.numpy() for x in got)
    differ = int((ok_j != ok_t).sum())
    assert differ <= MASK_ALLOWANCE * n_cand, (differ, n_cand)
    both = ok_j & ok_t
    assert both.sum() >= 50, both.sum()
    np.testing.assert_array_equal(m_t[both], m_j[both])
    assert np.abs(X_t[both] - X_j[both]).max() < X_TOL_M
    return both


def test_triangulate_multi_and_pair_match_jax():
    sc = _point_scene()
    uv_a, desc_a, cand_a, oct_a, uv_b, desc_b, cand_b, oct_b, T_ab = sc
    want = jtri.triangulate_multi(
        JCAM, *(jnp.asarray(a) for a in sc), scale_factor=1.2)
    got = ttri.triangulate_multi(
        TCAM, t(uv_a), t(desc_a.astype(np.int64)), t(cand_a), t(oct_a), t(uv_b),
        t(desc_b.astype(np.int64)), t(cand_b), t(oct_b), t(T_ab), scale_factor=1.2)
    both = _compare_points(want, got, cand_a.sum() * len(T_ab))
    # The accepted points are the scene's (a's first 200 rows), in front.
    assert (np.nonzero(both)[1] < 200).all()
    one = ttri.triangulate_pair(
        TCAM, t(uv_a), t(desc_a.astype(np.int64)), t(cand_a), t(oct_a), t(uv_b[1]),
        t(desc_b[1].astype(np.int64)), t(cand_b[1]), t(oct_b[1]), t(T_ab[1]))
    # The same function with no batch dims (its batched matmuls may round
    # differently in the last bits).
    ok1 = one.ok.numpy()
    np.testing.assert_array_equal(ok1, got.ok[1].numpy())
    np.testing.assert_array_equal(one.match_b.numpy(), got.match_b[1].numpy())
    np.testing.assert_allclose(one.X_a.numpy()[ok1], got.X_a[1].numpy()[ok1], atol=1e-5, rtol=0)


def _segments(T, X0, X1):
    return _project(T, X0)[0].astype(np.float32), _project(T, X1)[0].astype(np.float32)


def test_triangulate_lines_pair_matches_jax():
    rng = np.random.default_rng(4)
    C, n = 96, 60
    # Segments on planes 2-6 m ahead, 0.3-1 m long; one axis-aligned.
    X0 = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(2, 6, n)], 1)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[0] = [1.0, 0.0, 0.0]
    X1 = X0 + d * rng.uniform(0.3, 1.0, (n, 1))
    T_b, T_c = _pose(rng), _pose(rng)

    def view(T, perm):
        p0 = rng.uniform([0, 0], [640, 480], (C, 2)).astype(np.float32)
        p1 = p0 + rng.uniform(-60, 60, (C, 2)).astype(np.float32)
        q0, q1 = _segments(T, X0, X1)
        p0[perm[:n]], p1[perm[:n]] = q0 + rng.normal(size=q0.shape) * 0.2, q1 + rng.normal(size=q1.shape) * 0.2
        return p0, p1

    ident = np.arange(C)
    perm_b, perm_c = rng.permutation(C), rng.permutation(C)
    p0_a, p1_a = view(np.eye(4), ident)
    p0_b, p1_b = view(T_b, perm_b)
    p0_c, p1_c = view(T_c, perm_c)
    desc_a = rng.normal(size=(C, 36)).astype(np.float32)
    desc_b = rng.normal(size=(C, 36)).astype(np.float32)
    desc_b[perm_b[:n]] = desc_a[:n] + 0.2 * rng.normal(size=(n, 36))
    desc_a /= np.linalg.norm(desc_a, axis=1, keepdims=True)
    desc_b /= np.linalg.norm(desc_b, axis=1, keepdims=True)
    cand_a = rng.uniform(size=C) > 0.05
    cand_b = rng.uniform(size=C) > 0.05
    seg_c = rng.uniform(size=C) > 0.05
    T_ab = np.linalg.inv(T_b).astype(np.float32)
    T_ca = T_c.astype(np.float32)
    args = (p0_a, p1_a, desc_a, cand_a, p0_b, p1_b, desc_b, cand_b, T_ab, p0_c, p1_c, seg_c, T_ca)
    want = [np.asarray(x) for x in jtri.triangulate_lines_pair(JCAM, *(jnp.asarray(a) for a in args))]
    got = [x.numpy() for x in ttri.triangulate_lines_pair(TCAM, *(t(a) for a in args))]
    ok_j, ok_t = want[3], got[3]
    assert (ok_j != ok_t).sum() <= MASK_ALLOWANCE * cand_a.sum()
    both = ok_j & ok_t
    assert both.sum() >= 20, both.sum()
    assert (np.nonzero(both)[0] < n).all()
    np.testing.assert_array_equal(got[2][both], want[2][both])
    for k in (0, 1):
        assert np.abs(got[k][both] - want[k][both]).max() < X_TOL_M
    # The accepted endpoints lie on their true 3D lines.
    i = np.nonzero(both)[0]
    for Xk in (got[0][i], got[1][i]):
        rel = Xk - X0[i]
        perp = rel - np.sum(rel * d[i], 1, keepdims=True) * d[i]
        assert np.median(np.linalg.norm(perp, axis=1)) < 0.05
