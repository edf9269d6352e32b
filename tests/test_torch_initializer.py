"""The two-view initializer against hfvo_tpu's, on the three scenes of
tests/test_initializer.py (general, planar, too few matches).

The JAX package draws its (128, 8) hypothesis samples from a threefry
stream, so the port's core is fed the JAX package's own draw
(`jax_draw`, the draw of hfvo_tpu/solve/initializer.py:143).

Each F and H hypothesis is the null vector of an 8 x 9 system, which
float32 resolves only to a few per cent in LAPACK and in XLA alike (the
median hypothesis of the general scene differs by 5 % between them, as
the DLT of PnP shows in test_torch_reloc.py), and the best of 128 scores lie within
0.01 % of each other, so the two packages can pick different hypotheses
from the same draw. So the stages are held apart:
- from the JAX package's own hypotheses, the port's selection and
  reconstruction: equal `ok` and `used_H`, equal inlier masks, `T_21`
  within 1e-4;
- the port's hypotheses fit their samples as well as the JAX package's (the
  largest and the median epipolar residual of the rank-2 F's on their own
  samples within 2x of the JAX package's);
- the whole core on the JAX draw: equal `ok` and `used_H`, and on the
  general scene `T_21` within the JAX tests' own gates of the JAX
  package's (rotation 0.01 rad, translation direction cosine 0.995).
The wrapper, on the port's own draw, is held to the JAX tests' gates."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.solve import initializer as jinit
from hfvo_tpu_torch.config import tum3_config
from hfvo_tpu_torch.geometry import se3 as tse3
from hfvo_tpu_torch.solve import initializer as tinit
from test_initializer import two_view
from test_torch_reloc import jax_draw
from torch_helpers import t

JINTR = jax_tum3().camera
TINTR = tum3_config().camera


def _scene(case):
    rng = np.random.default_rng(0)
    T_gt, X, uv1, uv2 = two_view(rng, planar=(case == "planar"))
    valid = np.ones((200,), bool)
    if case == "few":
        valid[10:] = False
    return T_gt, uv1, uv2, valid, {"general": 0, "planar": 1, "few": 2}[case]


def _rot_gap(Ta, Tb):
    R = Ta[:3, :3] @ Tb[:3, :3].T
    return np.abs(tse3.log_so3(t(R.astype(np.float32))).numpy()).max()


def _dir_cos(Ta, Tb):
    a, b = Ta[:3, 3], Tb[:3, 3]
    return abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))


@jax.jit
def _jax_hypotheses_jit(uv1, uv2, idx8):
    """The first stage of hfvo_tpu/solve/initializer.py:139-153, jitted as
    there (op by op, XLA rounds the hypotheses differently)."""
    x1 = jinit._normalize(uv1, JINTR)
    x2 = jinit._normalize(uv2, JINTR)
    Fs = jax.vmap(jinit._dlt_F)(x1[idx8], x2[idx8])
    Hs = jax.vmap(jinit._dlt_H)(x1[idx8[:, :4]], x2[idx8[:, :4]])
    return x1, x2, Fs, Hs


def _jax_hypotheses(uv1, uv2, idx8):
    out = _jax_hypotheses_jit(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(idx8.numpy()))
    return tuple(np.array(a) for a in out)


@pytest.mark.parametrize("case", ["general", "planar", "few"])
def test_selection_and_reconstruction_match_jax(case):
    _, uv1, uv2, valid, seed = _scene(case)
    want = jinit.initialize_two_view(JINTR, jnp.asarray(uv1), jnp.asarray(uv2),
                                     jnp.asarray(valid), jnp.uint32(seed))
    x1, x2, Fs, Hs = _jax_hypotheses(uv1, uv2, jax_draw(valid, tinit.N_HYP, 8, seed))
    got = tinit.select_and_reconstruct(t(x1), t(x2), t(valid), t(Fs), t(Hs))
    assert bool(got.ok) == bool(want.ok)
    assert bool(got.used_H) == bool(want.used_H)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.T_21.numpy(), np.asarray(want.T_21), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(got.score_f), float(want.score_f), rtol=1e-4)
    np.testing.assert_allclose(float(got.score_h), float(want.score_h), rtol=1e-4)


def _residuals(F, x1, x2):
    """|x2h^T F x1h| over each hypothesis' own 8 samples, F normalized."""
    F = F / np.linalg.norm(F, axis=(-2, -1), keepdims=True)
    h1 = np.concatenate([x1, np.ones_like(x1[..., :1])], -1)
    h2 = np.concatenate([x2, np.ones_like(x2[..., :1])], -1)
    return np.abs(np.einsum("hni,hij,hnj->hn", h2, F, h1)).max(-1)


@pytest.mark.parametrize("case", ["general", "planar", "few"])
def test_core_on_the_jax_draw(case):
    T_gt, uv1, uv2, valid, seed = _scene(case)
    want = jinit.initialize_two_view(JINTR, jnp.asarray(uv1), jnp.asarray(uv2),
                                     jnp.asarray(valid), jnp.uint32(seed))
    idx8 = jax_draw(valid, tinit.N_HYP, 8, seed)
    x1, x2, Fs_j, _ = _jax_hypotheses(uv1, uv2, idx8)
    Fs_p = tinit._dlt_F(t(x1)[idx8], t(x2)[idx8]).numpy()
    i = idx8.numpy()
    r_j = _residuals(Fs_j.astype(np.float64), x1[i], x2[i])
    r_p = _residuals(Fs_p.astype(np.float64), x1[i], x2[i])
    assert r_p.max() <= 2 * r_j.max(), (r_p.max(), r_j.max())
    assert np.median(r_p) <= 2 * np.median(r_j), (np.median(r_p), np.median(r_j))
    got = tinit.initialize_two_view_core(TINTR, t(uv1), t(uv2), t(valid), idx8)
    assert bool(got.ok) == bool(want.ok)
    assert bool(got.used_H) == bool(want.used_H)
    if case == "general":  # a planar scene leaves F's pose undetermined
        Tp, Tj = got.T_21.numpy(), np.asarray(want.T_21)
        assert _rot_gap(Tp, Tj) < 0.01 and _dir_cos(Tp, Tj) > 0.995
    assert bool(got.ok) == (case != "few")
    assert bool(got.used_H) == (case == "planar")


def test_wrapper_meets_the_jax_gates():
    T_gt, uv1, uv2, valid, _ = _scene("general")
    res = tinit.initialize_two_view(TINTR, t(uv1), t(uv2), t(valid), 0)
    assert bool(res.ok) and not bool(res.used_H)
    T = res.T_21.numpy()
    assert _rot_gap(T_gt, T) < 0.01 and _dir_cos(T, T_gt) > 0.995
    _, uv1p, uv2p, _, _ = _scene("planar")
    assert bool(tinit.initialize_two_view(TINTR, t(uv1p), t(uv2p), t(valid), 1).used_H)
    few = valid.copy()
    few[10:] = False
    assert not bool(tinit.initialize_two_view(TINTR, t(uv1), t(uv2), t(few), 2).ok)
