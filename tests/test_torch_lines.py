"""Line detection: kernel K3's plain version, `detect_lines` and its parts,
against hfvo_tpu's on the same numpy inputs (CPU).

- K3's plain version (`hough_vote_reference`) against the JAX package's f32
  scan (`_scan_acc` of tests/test_pallas_hough.py) on the same magnitude and
  angle images: relative error (|d| / max(|ref|, 1)) <= 1e-5 and the same
  top-4 bins in every tile whose 4th and 5th values are apart. Only the sum
  order differs.
- Against the TPU kernel run in interpret mode (bf16 one-hot matmuls), under
  that test's own gates: mean relative error < 0.005, max < 0.05, >= 3.5
  shared top-4 peaks a tile.
- K3b, the plain version on an (S, H, W) stack, against `jax.vmap` of the
  TPU kernel in interpret mode (its batched rule, `pallas_hough.py:122-127`)
  under tests/test_pallas_hough.py::test_vote_batched_rule's bound (max
  relative error < 0.02), and against the f32 scan of each image with
  test_vote_matches_scan's three checks and the tight bound above.
- `detect_lines` on a rendered 480x640 frame and on the striped image of
  tests/test_pallas_hough.py: the same valid mask, endpoints within 0.05 px,
  descriptors within 1e-4 (float32 reduction order and ulp-level atan2 /
  sqrt differences only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfvo_tpu.ops import image as jimg
from hfvo_tpu.ops import lines as jl
from hfvo_tpu.ops.pallas_hough import hough_vote_pallas
from hfvo_tpu_torch.ops import image as timg
from hfvo_tpu_torch.ops import lines as tl
import jax
from test_pallas_hough import _scan_acc, _scan_reference, _to_tiles
from torch_helpers import t

SHAPES = [(256, 320), (192, 448), (128, 128)]


def _mag_ang(shape, seed=0):
    gray = np.random.default_rng(seed).uniform(0, 255, size=shape).astype(np.float32)
    mag, na = _scan_reference(jnp.asarray(gray), 12.0)
    return np.asarray(mag), np.asarray(na)


def _top4_agree(got, ref, rel_gap=1e-4):
    """Top-4 bins equal in every tile whose ranked 4th and 5th values are
    more than `rel_gap` apart (elsewhere the 4th place is a tie)."""
    for k in range(ref.shape[0]):
        r, g = ref[k].ravel(), got[k].ravel()
        srt = np.sort(r)[::-1]
        if srt[3] - srt[4] <= rel_gap * max(abs(srt[3]), 1.0):
            continue
        assert set(np.argsort(r)[-4:]) == set(np.argsort(g)[-4:]), f"tile {k}"


@pytest.mark.parametrize("shape", SHAPES)
def test_vote_plain_matches_jax_scan(shape):
    mag, na = _mag_ang(shape)
    ref = np.asarray(_scan_acc(jnp.asarray(mag), jnp.asarray(na), 12.0))
    got = tl.hough_vote_reference(t(mag), t(na), 12.0).numpy()
    assert got.shape == ref.shape
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    assert rel.max() <= 1e-5, rel.max()
    _top4_agree(got, ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_vote_plain_within_tpu_kernel_gates(shape):
    mag, na = _mag_ang(shape)
    kern = np.asarray(hough_vote_pallas(_to_tiles(jnp.asarray(mag)), _to_tiles(jnp.asarray(na)),
                                        12.0, interpret=True))
    got = tl.hough_vote_reference(t(mag), t(na), 12.0).numpy()
    rel = np.abs(kern - got) / np.maximum(np.abs(got), 1.0)
    assert rel.mean() < 0.005 and rel.max() < 0.05
    g_top = np.argsort(got.reshape(got.shape[0], -1), axis=1)[:, -4:]
    k_top = np.argsort(kern.reshape(kern.shape[0], -1), axis=1)[:, -4:]
    assert np.mean([len(set(a) & set(b)) for a, b in zip(g_top, k_top)]) >= 3.5


def test_vote_wrapper_takes_plain_version_on_cpu():
    mag, na = _mag_ang((128, 192), seed=3)
    before = tl.hough_vote_launches
    np.testing.assert_array_equal(
        tl.hough_vote(t(mag), t(na), 12.0).numpy(),
        tl.hough_vote_reference(t(mag), t(na), 12.0).numpy(),
    )
    assert tl.hough_vote_launches == before


def test_vote_wrapper_refuses_other_devices():
    z = torch.zeros((64, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tl.hough_vote(z, z, 12.0)


def test_theta_table_is_the_bin_centres():
    """Within the float32 rounding of the angle (half an ulp of pi, 1.2e-7)
    and of the result."""
    th = (np.arange(tl.N_THETA) + 0.5) / tl.N_THETA * np.pi
    np.testing.assert_allclose(tl.theta_table(), np.stack([np.cos(th), np.sin(th)]), atol=2e-7, rtol=0)


def _stripes():
    img = np.zeros((256, 320), np.float32)
    for x0 in range(40, 320 - 40, 60):
        img[:, x0 : x0 + 4] = 200.0
    return img


@pytest.fixture(scope="module")
def rendered_u8():
    """A rendered 480x640 frame, uint8-truncated as tracked frames are."""
    from hfvo_tpu_torch.testing import synthetic

    _, grays, _ = synthetic.render_sequence(n=4, seed=0)
    return np.clip(grays[3], 0, 255).astype(np.uint8).astype(np.float32)


@pytest.mark.parametrize("image", ["rendered", "stripes"])
def test_detect_lines_matches_jax(image, rendered_u8):
    gray = rendered_u8 if image == "rendered" else _stripes()
    want = [np.asarray(a) for a in jl.detect_lines(jnp.asarray(gray))]
    got = [a.numpy() for a in tl.detect_lines(t(gray))]
    wv, gv = want[5], got[5]
    assert wv.sum() >= 4
    np.testing.assert_array_equal(gv, wv)
    # Segments as sets: each valid segment has its partner within 0.05 px.
    wseg = np.concatenate([want[0][wv], want[1][wv]], axis=1)
    gseg = np.concatenate([got[0][gv], got[1][gv]], axis=1)
    gap = np.abs(wseg[:, None, :] - gseg[None, :, :]).max(-1)
    assert gap.min(axis=1).max() < 0.05 and gap.min(axis=0).max() < 0.05
    partner = gap.argmin(axis=1)
    np.testing.assert_allclose(got[4][gv][partner], want[4][wv], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[2][gv][partner], want[2][wv], atol=1e-4, rtol=0)


def test_flip_is_exact_descriptor_permutation():
    """The canonical-orientation flip relies on band_descriptors(p1, p0)
    being the bands-reversed, channels-swapped band_descriptors(p0, p1)
    (tests/test_pallas_hough.py:134); checked on the port, and the port's
    descriptors against the JAX package's."""
    rng = np.random.default_rng(2)
    gray = rng.uniform(0, 255, size=(128, 160)).astype(np.float32)
    p0 = rng.uniform(10, 110, size=(20, 2)).astype(np.float32)
    p1 = rng.uniform(10, 110, size=(20, 2)).astype(np.float32)
    gx, gy = timg.sobel_gradients(t(gray))
    fwd = tl.band_descriptors(t(gray), gx, gy, t(p0), t(p1)).numpy()
    bwd = tl.band_descriptors(t(gray), gx, gy, t(p1), t(p0)).numpy()
    perm = fwd.reshape(20, tl.DESC_BANDS, 4)[:, ::-1, :][:, :, [1, 0, 3, 2]]
    np.testing.assert_allclose(bwd, perm.reshape(20, -1), rtol=1e-5, atol=1e-6)
    jgx, jgy = jimg.sobel_gradients(jnp.asarray(gray))
    want = np.asarray(jl.band_descriptors(jnp.asarray(gray), jgx, jgy, jnp.asarray(p0), jnp.asarray(p1)))
    np.testing.assert_allclose(fwd, want, atol=1e-5, rtol=0)


def test_merge_collinear_matches_jax():
    """Fragments of 6 lines, jittered, merge to the same segments."""
    rng = np.random.default_rng(5)
    p0, p1 = [], []
    for k in range(6):
        a = rng.uniform(0, np.pi)
        u = np.array([np.cos(a), np.sin(a)])
        base = rng.uniform(100, 300, 2)
        for s in range(4):
            p0.append(base + u * (s * 30.0) + rng.normal(0, 0.3, 2))
            p1.append(base + u * (s * 30.0 + 25.0) + rng.normal(0, 0.3, 2))
    p0 = np.array(p0, np.float32)
    p1 = np.array(p1, np.float32)
    strength = rng.uniform(50, 500, len(p0)).astype(np.float32)
    valid = np.ones(len(p0), bool)
    want = [np.asarray(a) for a in jl.merge_collinear(jnp.asarray(p0), jnp.asarray(p1),
                                                      jnp.asarray(strength), jnp.asarray(valid))]
    got = [a.numpy() for a in tl.merge_collinear(t(p0), t(p1), t(strength), t(valid))]
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].sum() < len(p0)
    np.testing.assert_allclose(got[0][got[2]], want[0][want[2]], atol=1e-3)
    np.testing.assert_allclose(got[1][got[2]], want[1][want[2]], atol=1e-3)


def test_line2d_and_distance_matrix_match_jax(rendered_u8):
    lf_j = jl.detect_lines(jnp.asarray(rendered_u8))
    lf_t = tl.LineFeatures(*(t(np.asarray(a)) for a in lf_j))
    np.testing.assert_allclose(lf_t.line2d.numpy(), np.asarray(lf_j.line2d), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(lf_t.length.numpy(), np.asarray(lf_j.length), rtol=1e-6)
    D = tl.line_distance_matrix(lf_t.desc, lf_t.desc).numpy()
    np.testing.assert_allclose(D, np.asarray(jl.line_distance_matrix(lf_j.desc, lf_j.desc)), atol=1e-5)


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    xy = rng.uniform(-5, 90, (500, 2)).astype(np.float32)
    want = np.asarray(jimg.bilinear_sample(jnp.asarray(img), jnp.asarray(xy)))
    got = timg.bilinear_sample(t(img), t(xy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)



@pytest.fixture(scope="module")
def batch_mag_ang():
    """Magnitude and angle (3, 128, 192) of test_vote_batched_rule's noise."""
    grays = np.random.default_rng(1).uniform(0, 255, size=(3, 128, 192)).astype(np.float32)
    mags, nas = jax.vmap(lambda g: _scan_reference(g, 12.0))(jnp.asarray(grays))
    return np.asarray(mags), np.asarray(nas)


def test_batched_vote_plain_matches_tpu_kernel_vmap(batch_mag_ang):
    mags, nas = batch_mag_ang
    kern = np.asarray(jax.vmap(lambda m, n: hough_vote_pallas(m, n, 12.0, interpret=True))(
        jax.vmap(_to_tiles)(jnp.asarray(mags)), jax.vmap(_to_tiles)(jnp.asarray(nas))))
    got = tl.hough_vote_reference(t(mags), t(nas), 12.0).numpy()
    assert got.shape == kern.shape == (3, 6, tl.N_THETA, tl.N_RHO)
    assert (np.abs(kern - got) / np.maximum(np.abs(got), 1.0)).max() < 0.02


def test_batched_vote_plain_matches_scan(batch_mag_ang):
    mags, nas = batch_mag_ang
    got = tl.hough_vote_reference(t(mags), t(nas), 12.0).numpy()
    for i in range(3):
        ref = np.asarray(_scan_acc(jnp.asarray(mags[i]), jnp.asarray(nas[i]), 12.0))
        rel = np.abs(got[i] - ref) / np.maximum(np.abs(ref), 1.0)
        assert rel.mean() < 0.005 and rel.max() < 0.05
        r_top = np.argsort(ref.reshape(ref.shape[0], -1), axis=1)[:, -4:]
        g_top = np.argsort(got[i].reshape(ref.shape[0], -1), axis=1)[:, -4:]
        assert np.mean([len(set(a) & set(b)) for a, b in zip(r_top, g_top)]) >= 3.5
        assert rel.max() <= 1e-5, rel.max()
        _top4_agree(got[i], ref)


def test_detect_lines_batched_equals_single(rendered_u8):
    """detect_lines on a (2, H, W) stack returns each image's own segments
    (the image and its left-right mirror)."""
    imgs = np.stack([rendered_u8, rendered_u8[:, ::-1].copy()])
    got = tl.detect_lines(t(imgs))
    for i in range(2):
        one = tl.detect_lines(t(imgs[i]))
        for name, a, b in zip(one._fields, got, one):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), atol=1e-5, rtol=0, err_msg=name)
