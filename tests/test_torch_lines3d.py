"""3D lines: `eigh3`, `fit_lines_3d` and the structural refinement
(`discover_pairs`, `discover_pairs_vs_map`, `line_opt_struct`) against
hfvo_tpu's on the same numpy inputs (CPU).

- `eigh3`: eigenvalues within 1e-5 relative and eigenvectors within 1e-5,
  with the same sign (both run the same Jacobi sweeps from the identity).
  Eigenvectors are compared where their eigenvalue is separated from the
  others: inside a degenerate eigenspace (the two ~0 eigenvalues of a
  rank-one covariance) any orthonormal basis is right, and ulp-level
  differences turn it.
- `fit_lines_3d` on the segments of a rendered 480x640 frame: the same valid
  mask and endpoints within 1e-5 m in the same X0/X1 order.
- Pair masks equal; `line_opt_struct` endpoints within 1e-5 m.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.ops import lines as jl
from hfvo_tpu.ops import lines3d as jl3
from hfvo_tpu.ops import structural as jst
from hfvo_tpu.ops import sym_eig as jeig
from hfvo_tpu_torch import convert
from hfvo_tpu_torch.config import tum3_config
from hfvo_tpu_torch.ops import lines3d as tl3
from hfvo_tpu_torch.ops import structural as tst
from hfvo_tpu_torch.ops import sym_eig as teig
from torch_helpers import t

JCAM = jax_tum3().camera
TCAM = tum3_config().camera


def _sym_batch():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1)
    A[0] = 0.0  # all-zero block (masked-out rows)
    A[1] = np.diag([1e-12, 1e-12, 1e-12])  # equal eigenvalues
    v = rng.normal(size=(3,))
    A[2] = np.outer(v, v)  # rank one, as a clean 3D line's covariance
    return A.astype(np.float32)


def test_eigh3_matches_jax():
    A = _sym_batch()
    w_j, V_j = (np.asarray(a) for a in jeig.eigh3(jnp.asarray(A)))
    w_t, V_t = (a.numpy() for a in teig.eigh3(t(A)))
    np.testing.assert_allclose(w_t, w_j, rtol=1e-5, atol=1e-6)
    gap = np.where(np.eye(3, dtype=bool), np.inf, np.abs(w_j[:, :, None] - w_j[:, None, :]))
    separated = gap.min(axis=2) > 1e-4 * np.abs(w_j).max(axis=1, keepdims=True)
    assert separated.sum() == 3 * 61 + 1  # and the rank-one block's top vector
    err = np.abs(V_t - V_j).max(axis=1)  # (B, column)
    assert err[separated].max() <= 1e-5, err[separated].max()


def test_line_pairs_table_matches_jax():
    from hfvo_tpu.bow import vocab as jv
    from hfvo_tpu.ops import orb as jo

    convert.constants_from_numpy(jo.BRIEF_PATTERN, jo.BIN_DIFF_MATS, jv.PROTOTYPES, jl3._PAIRS)
    bad = np.array(jl3._PAIRS)
    bad[0, 0] += 1
    with pytest.raises(ValueError, match="_PAIRS"):
        convert.constants_from_numpy(jo.BRIEF_PATTERN, jo.BIN_DIFF_MATS, jv.PROTOTYPES, bad)


@pytest.fixture(scope="module")
def frame_lines():
    """(depth, LineFeatures as numpy, JAX Lines3D as numpy) for frame 3 of
    the renderer's orbit at 480x640."""
    from hfvo_tpu_torch.testing import synthetic

    _, grays, depths = synthetic.render_sequence(n=4, seed=0)
    lf = [np.asarray(a) for a in jl.detect_lines(jnp.asarray(grays[3]))]
    l3d = jl3.fit_lines_3d(jnp.asarray(depths[3]), JCAM, jnp.asarray(lf[0]),
                           jnp.asarray(lf[1]), jnp.asarray(lf[5]))
    return depths[3], lf, [np.asarray(a) for a in l3d]


def test_fit_lines_3d_matches_jax(frame_lines):
    depth, lf, want = frame_lines
    got = [a.numpy() for a in tl3.fit_lines_3d(t(depth), TCAM, t(lf[0]), t(lf[1]), t(lf[5]))]
    assert want[2].sum() >= 10
    np.testing.assert_array_equal(got[2], want[2])
    v = want[2]
    np.testing.assert_allclose(got[0][v], want[0][v], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1][v], want[1][v], atol=1e-5, rtol=0)


def test_fit_order_on_constant_depth_is_a_rounding_artefact():
    """Frame 0 of the orbit looks straight at a wall: every sample along a
    line there has the same depth, the line's covariance has an exactly
    degenerate depth axis, and which end becomes X0 follows the sign of
    rounding noise in the Jacobi sweeps. The JAX package's own order there
    changes between its jitted and op-by-op runs of the same inputs. The
    port gives the same valid set and the same endpoints as unordered pairs
    within 1e-5 m, and orients these lines along their 2D segment (X0 at the
    p0 end), the same on every device (ROADMAP queue 3)."""
    import jax

    from hfvo_tpu_torch.testing import synthetic

    _, grays, depths = synthetic.render_sequence(n=1, seed=0)
    lf = [np.asarray(a) for a in jl.detect_lines(jnp.asarray(grays[0]))]
    args = (jnp.asarray(depths[0]), JCAM, jnp.asarray(lf[0]), jnp.asarray(lf[1]), jnp.asarray(lf[5]))
    jit = [np.asarray(a) for a in jl3.fit_lines_3d(*args)]
    with jax.disable_jit():
        eager = [np.asarray(a) for a in jl3.fit_lines_3d(*args)]
    v = jit[2]
    assert v.sum() >= 20
    np.testing.assert_array_equal(eager[2], v)
    assert (np.abs(jit[0] - eager[0]).max(axis=1)[v] > 1e-3).any()  # JAX vs JAX
    got = [a.numpy() for a in tl3.fit_lines_3d(t(depths[0]), TCAM, t(lf[0]), t(lf[1]), t(lf[5]))]
    np.testing.assert_array_equal(got[2], v)
    same = np.maximum(np.abs(got[0] - jit[0]), np.abs(got[1] - jit[1])).max(axis=1)
    swapped = np.maximum(np.abs(got[0] - jit[1]), np.abs(got[1] - jit[0])).max(axis=1)
    assert (np.minimum(same, swapped)[v] < 1e-5).all()
    proj = np.stack([TCAM.fx * (got[1] - got[0])[:, 0], TCAM.fy * (got[1] - got[0])[:, 1]], axis=1)
    assert (np.sum(proj * (lf[1] - lf[0]), axis=1)[v] > 0).all()


def _unit(d):
    return d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9)


@pytest.fixture(scope="module")
def struct_inputs(frame_lines):
    """Measured 3D lines of the frame, their pair masks from the JAX
    package, and 40 map directions: 20 near the frame's own directions,
    20 random."""
    _, lf, l3d = frame_lines
    v3 = lf[5] & l3d[2]
    d3 = _unit(l3d[1] - l3d[0]).astype(np.float32)
    d2 = _unit(lf[1] - lf[0]).astype(np.float32)
    rng = np.random.default_rng(1)
    near = d3[np.nonzero(v3)[0][:20]] + rng.normal(0, 0.02, (20, 3))
    md = _unit(np.concatenate([near, rng.normal(size=(20, 3))])).astype(np.float32)
    mvalid = np.ones(40, bool)
    mvalid[5] = False
    return l3d, v3, d2, d3, md, mvalid


def test_discover_pairs_match_jax(struct_inputs):
    _, v3, d2, d3, md, mvalid = struct_inputs
    want = jst.discover_pairs(jnp.asarray(d2), jnp.asarray(d3), jnp.asarray(v3))
    got = tst.discover_pairs(t(d2), t(d3), t(v3))
    assert np.asarray(want.par).sum() + np.asarray(want.perp).sum() > 0
    np.testing.assert_array_equal(got.par.numpy(), np.asarray(want.par))
    np.testing.assert_array_equal(got.perp.numpy(), np.asarray(want.perp))
    wm = jst.discover_pairs_vs_map(jnp.asarray(d3), jnp.asarray(v3), jnp.asarray(md), jnp.asarray(mvalid))
    gm = tst.discover_pairs_vs_map(t(d3), t(v3), t(md), t(mvalid))
    assert np.asarray(wm[0]).sum() > 0
    for g, w in zip(gm, wm):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("with_map", [False, True])
def test_line_opt_struct_matches_jax(struct_inputs, with_map):
    l3d, v3, d2, d3, md, mvalid = struct_inputs
    pairs = jst.discover_pairs(jnp.asarray(d2), jnp.asarray(d3), jnp.asarray(v3))
    zero_ax = np.zeros_like(d3)
    no_ax = np.zeros_like(v3)
    kw_j, kw_t = {}, {}
    if with_map:
        pm, qm = jst.discover_pairs_vs_map(jnp.asarray(d3), jnp.asarray(v3), jnp.asarray(md),
                                           jnp.asarray(mvalid))
        kw_j = dict(map_dir=jnp.asarray(md), par_map=pm, perp_map=qm)
        kw_t = dict(map_dir=t(md), par_map=t(np.asarray(pm)), perp_map=t(np.asarray(qm)))
    want = jst.line_opt_struct(jnp.asarray(l3d[0]), jnp.asarray(l3d[1]), jnp.asarray(v3),
                               pairs.par, pairs.perp, jnp.asarray(zero_ax), jnp.asarray(no_ax), **kw_j)
    got = tst.line_opt_struct(t(l3d[0]), t(l3d[1]), t(v3), t(np.asarray(pairs.par)),
                              t(np.asarray(pairs.perp)), t(zero_ax), t(no_ax), **kw_t)
    moved = np.abs(np.asarray(want[0]) - l3d[0])[v3].max()
    assert moved > 1e-4  # the refinement does move the endpoints
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[v3], np.asarray(w)[v3], atol=1e-5, rtol=0)

