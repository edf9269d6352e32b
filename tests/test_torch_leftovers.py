"""The JAX package's functions that no tracking path calls: `pyr_lk` and
`recover_line_by_flow` (ops/lk.py), `binarize_band_desc` (ops/lines.py)
and `inv6x6_blocked` (ops/sym_eig.py), against hfvo_tpu's on the same
seeded numpy inputs (CPU), and the protocols of tests/test_lk.py on the
port.

Tolerances: `inv6x6_blocked` relative error 1e-4 against JAX and against a
float64 inverse; `binarize_band_desc` bit-equal; `pyr_lk` the same `ok`
except where the JAX package's 5x5 photometric error lies within 1e-3 of
its 12.0 gate, and tracked points within 1e-3 px where both say ok;
`recover_line_by_flow` the same `ok` and segment ends within 0.05 px.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfvo_tpu.ops import hamming as jham
from hfvo_tpu.ops import image as jimg
from hfvo_tpu.ops import lines as jl
from hfvo_tpu.ops import lk as jlk
from hfvo_tpu.ops import sym_eig as jse
from hfvo_tpu_torch.config import tum3_config
from hfvo_tpu_torch.geometry import se3
from hfvo_tpu_torch.ops import hamming as tham
from hfvo_tpu_torch.ops import lines as tl
from hfvo_tpu_torch.ops import lk as tlk
from hfvo_tpu_torch.ops import sym_eig as tse
from hfvo_tpu_torch.testing import synthetic
from torch_helpers import t

INTR = tum3_config().camera


def _rel_err(got, ref):
    """Per-matrix Frobenius relative error, the largest over the batch."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float((np.linalg.norm(got - ref, axis=(-2, -1)) / np.linalg.norm(ref, axis=(-2, -1))).max())


def test_inv6x6_blocked_matches_jax_and_float64():
    # tests/test_sym_eig.py's damped blocks: the same generator, draws and
    # damping (the 3x3 draw comes first there).
    rng = np.random.default_rng(0)
    rng.normal(size=(64, 3, 3))
    B = rng.normal(size=(32, 6, 6)).astype(np.float32)
    B = (B @ B.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    got = tse.inv6x6_blocked(t(B)).numpy()
    assert got.shape == (32, 6, 6) and got.dtype == np.float32
    assert _rel_err(got, np.asarray(jse.inv6x6_blocked(jnp.asarray(B)))) <= 1e-4
    assert _rel_err(got, np.linalg.inv(B.astype(np.float64))) <= 1e-4
    # Leading batch dims, as every port op takes them.
    np.testing.assert_array_equal(tse.inv6x6_blocked(t(B.reshape(4, 8, 6, 6))).numpy().reshape(32, 6, 6), got)


def test_binarize_band_desc_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    d = rng.uniform(0, 1, (96, 4 * tl.DESC_BANDS)).astype(np.float32)
    d[:, 7] = d[:, 3]  # a tied pair in every row
    d[:16] = np.round(d[:16] * 3) / 3  # rows of 4 levels: many ties
    d[16:20] = 0.0  # all tied: every bit 0
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
    assert np.array_equal(tl._BIN_PAIRS, np.asarray(jl._BIN_PAIRS))
    want = np.asarray(jl.binarize_band_desc(jnp.asarray(d)))
    got = tl.binarize_band_desc(t(d))
    assert got.dtype == torch.int64 and got.shape == (96, 8)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (got[16:20] == 0).all() and (got.numpy() >= 0).all() and (got.numpy() < 2**32).all()
    # The port's Hamming matcher reads them as the JAX package's reads its own.
    np.testing.assert_array_equal(tham.hamming_matrix(got, got[:40]).numpy(),
                                  np.asarray(jham.hamming_matrix(want, want[:40])))


def _textured(rng, h=240, w=320):
    """tests/test_lk.py's textured frame: uniform noise at 1/8 resolution,
    cubic-upsampled (by JAX, so both packages get the same pixels)."""
    base = rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32)
    return np.asarray(jax.image.resize(jnp.asarray(base), (h, w), "cubic"))


def _jax_photo_err(img0, img1, p0, p1):
    """The JAX package's 5x5 photometric error of pyr_lk's gate."""
    a = np.arange(-2, 3, dtype=np.float32)
    offs = np.stack(np.meshgrid(a, a, indexing="xy"), -1).reshape(-1, 2)
    s1 = jimg.bilinear_sample(jnp.asarray(img1), jnp.asarray(p1[:, None, :] + offs))
    s0 = jimg.bilinear_sample(jnp.asarray(img0), jnp.asarray(p0[:, None, :] + offs))
    return np.asarray(jnp.mean(jnp.abs(s1 - s0), axis=1))


def _assert_lk_parity(img0, img1, p0, p1_init):
    want = [np.asarray(a) for a in jlk.pyr_lk(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(p0),
                                               jnp.asarray(p1_init))]
    got = [a.numpy() for a in tlk.pyr_lk(t(img0), t(img1), t(p0), t(p1_init))]
    err = _jax_photo_err(img0, img1, p0, want[0])
    near_gate = np.abs(err - 12.0) <= 1e-3
    np.testing.assert_array_equal(got[1][~near_gate], want[1][~near_gate])
    both = got[1] & want[1]
    assert np.abs(got[0][both] - want[0][both]).max() <= 1e-3
    return got, want


@pytest.fixture(scope="module")
def lk_frames():
    """tests/test_lk.py's frames and points, drawn as it draws them: img0
    and its first points from one generator of seed 0, img1 = img0 moved by
    (6, -4) px, and an unrelated frame (seed 99). (img0, img1, other, p0)."""
    rng = np.random.default_rng(0)
    img0 = _textured(rng)
    p0 = rng.uniform([40, 40], [280, 200], size=(50, 2)).astype(np.float32)
    img1 = np.roll(np.roll(img0, -4, axis=0), 6, axis=1)
    return img0, img1, _textured(np.random.default_rng(99)), p0


def test_pyr_lk_matches_jax(lk_frames):
    img0, img1, other, _ = lk_frames
    rng = np.random.default_rng(0)
    # Points over the whole frame, borders included, seeded near the answer
    # and from p0 itself; then the unrelated frame.
    p0 = rng.uniform([0, 0], [320, 240], size=(240, 2)).astype(np.float32)
    guess = (p0 + [6.0, -4.0] + rng.normal(0, 1.5, p0.shape)).astype(np.float32)
    got, want = _assert_lk_parity(img0, img1, p0, guess)
    assert 0.6 < want[1].mean() < 0.95  # both gates do reject points
    _assert_lk_parity(img0, img1, p0, p0)
    got, want = _assert_lk_parity(img0, other, p0, p0)
    assert want[1].mean() < 0.5


def test_pyr_lk_flat_patch_does_not_move(lk_frames):
    """On a flat patch G is 1e-4 I and b is 0: no update, in both packages."""
    img0 = lk_frames[0].copy()
    img0[100:140, 150:190] = 90.0
    p0 = np.array([[170.0, 120.0], [165.5, 115.25]], np.float32)
    guess = p0 + np.float32(0.5)
    got = tlk.pyr_lk(t(img0), t(img0), t(p0), t(guess), n_levels=1)[0].numpy()
    want = np.asarray(jlk.pyr_lk(jnp.asarray(img0), jnp.asarray(img0), jnp.asarray(p0), jnp.asarray(guess),
                                 n_levels=1)[0])
    np.testing.assert_array_equal(got, guess)
    np.testing.assert_array_equal(want, guess)
    # The 2x2 inverse of a flat patch's system, and of textured ones.
    G = np.random.default_rng(1).normal(size=(64, 2, 5)).astype(np.float32)
    G = (G @ G.transpose(0, 2, 1) * 50.0 + 1e-4 * np.eye(2)).astype(np.float32)
    G[0] = 1e-4 * np.eye(2, dtype=np.float32)
    (i00, i01), (i10, i11) = tlk._inv2x2(*(t(G[:, r, c]) for r in (0, 1) for c in (0, 1)))
    inv = torch.stack([torch.stack([i00, i01], -1), torch.stack([i10, i11], -1)], -2).numpy()
    ref = np.asarray(jax.vmap(jnp.linalg.inv)(jnp.asarray(G)))
    np.testing.assert_array_equal(inv[0], ref[0])
    assert _rel_err(inv, ref) <= 1e-6


def test_pyr_lk_translation_and_occlusion_protocols(lk_frames):
    """tests/test_lk.py's pure-translation and unrelated-frame protocols on
    the port alone (its 30 occlusion points are the first 30 of the 50)."""
    img0, img1, other, p0 = lk_frames
    p1, ok = (a.numpy() for a in tlk.pyr_lk(t(img0), t(img1), t(p0), t(p0)))
    assert ok.mean() > 0.8
    np.testing.assert_allclose(np.median(p1[ok] - p0[ok], axis=0), [6.0, -4.0], atol=0.3)
    q0 = p0[:30]
    assert tlk.pyr_lk(t(img0), t(other), t(q0), t(q0))[1].float().mean() < 0.5


@pytest.fixture(scope="module")
def rotated():
    """The port's renders of tests/test_lk.py's rotation protocol at 640x480:
    the camera 0.8 m back from the room's centre, then yawed by 0.04 and by
    0.03 rad. (gray0, {angle: (gray1, R)})."""
    scene = synthetic.make_room(0)
    T0 = torch.eye(4)
    T0[:3, 3] = torch.tensor([0.0, 0.0, -0.8])
    g0 = synthetic.render(scene, INTR, T0)[0].numpy()
    out = {}
    for a in (0.04, 0.03):
        R = se3.exp_so3(torch.tensor([0.0, a, 0.0]))
        T1 = T0.clone()
        T1[:3, :3] = T0[:3, :3] @ R
        out[a] = (synthetic.render(scene, INTR, T1)[0].numpy(), R.numpy())
    return g0, out


def test_pyr_lk_rotation_warp_protocol(rotated):
    g0, by_angle = rotated
    g1, R = by_angle[0.04]
    R_10 = np.ascontiguousarray(R.T)
    uv = np.random.default_rng(0).uniform([100, 100], [540, 380], size=(40, 2)).astype(np.float32)
    warped = tlk.warp_points_by_rotation(INTR, t(uv), t(R_10))
    p1, ok = (a.numpy() for a in tlk.pyr_lk(t(g0), t(g1), t(uv), warped))
    assert ok.mean() > 0.7
    assert np.median(np.linalg.norm(p1[ok] - warped.numpy()[ok], axis=1)) < 1.0


def test_recover_line_by_flow_matches_jax(rotated):
    """tests/test_lk.py::test_recover_line_by_flow's protocol: the longest
    detected line tracked across the 0.03 rad yaw lands within 3 px of a
    line detected in the next frame; the JAX package gives the same result
    on the same frames and segment."""
    g0, by_angle = rotated
    g1, R = by_angle[0.03]
    R_10 = np.ascontiguousarray(R.T)
    lf0 = tl.detect_lines(t(g0))
    i = int(torch.argmax(torch.where(lf0.valid, lf0.length, torch.zeros(()))))
    a, b = lf0.p0[i].numpy(), lf0.p1[i].numpy()
    q0, q1, ok = (x.numpy() for x in tlk.recover_line_by_flow(INTR, t(g0), t(g1), t(a), t(b), t(R_10)))
    w0, w1, wok = (np.asarray(x) for x in jlk.recover_line_by_flow(
        INTR, jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(a), jnp.asarray(b), jnp.asarray(R_10)))
    assert bool(ok) and bool(wok)
    assert np.abs(q0 - w0).max() <= 0.05 and np.abs(q1 - w1).max() <= 0.05, (q0, w0, q1, w1)
    lf1 = tl.detect_lines(t(g1))
    v1 = lf1.valid.numpy()
    p0_1, p1_1 = lf1.p0.numpy()[v1], lf1.p1.numpy()[v1]
    d = p1_1 - p0_1
    n = np.stack([-d[:, 1], d[:, 0]], 1)
    n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-9
    perp = np.abs((n * (0.5 * (q0 + q1) - p0_1)).sum(1))
    assert perp.min() < 3.0, perp.min()
