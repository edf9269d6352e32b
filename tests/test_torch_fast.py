"""FAST: the plain versions of kernels K1, K1b, K2 and K2b against
hfvo_tpu's jnp path and its Pallas kernels (interpret mode; the batched
ones under `jax.vmap`, which takes the kernels' batching rules to
`_dual_batched` and `_score_batched`), and the detector against hfvo_tpu's.
The CUDA kernels are held to their plain versions in
tests/test_torch_kernels.py.

Tolerances: corner sets (score > 0 and score > bonus) must be identical,
scores within atol 1e-4 (tests/test_pallas_fast.py's tolerance: float32
sum order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfvo_tpu.ops import fast as jfast
from hfvo_tpu.ops.pallas_fast import fast_score_dual_pallas, fast_score_pallas
from hfvo_tpu_torch.ops import fast as tfast
from torch_helpers import noise_image, small_frame, small_frames, t

IMAGES = {"rendered": lambda: small_frame()[0], "noise_250x330": noise_image}
# Stacks for the batched kernels: 3 noise images of 250x330 (seeds 7-9) and
# 2 rendered frames of 120x160.
STACKS = {
    "noise_3x250x330": lambda: np.stack([noise_image(seed=s) for s in (7, 8, 9)]),
    "rendered_2x120x160": lambda: np.stack([g for g, _ in small_frames((2, 3))]),
}


@jax.jit
def _jax_dual_jit(img):
    s_lo = jfast.fast_score(img, 7.0)
    s_hi = jfast.fast_score(img, 20.0)
    return jnp.where(s_hi > 0, s_hi + 1e4, s_lo)


def _jax_dual(img):
    return np.asarray(_jax_dual_jit(jnp.asarray(img)))


def _assert_same_corners(got, want, atol=1e-4, rtol=0.0):
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_array_equal(got > 1e4, want > 1e4)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("image", sorted(IMAGES))
def test_dual_reference_matches_jnp(image):
    img = IMAGES[image]()
    got = tfast.fast_score_dual_reference(t(img), 7.0, 20.0).numpy()
    _assert_same_corners(got, _jax_dual(img))
    assert (got > 1e4).sum() > 50


@pytest.mark.parametrize("image", sorted(IMAGES))
def test_dual_reference_matches_pallas_interpret(image):
    img = IMAGES[image]()
    want = np.asarray(fast_score_dual_pallas(jnp.asarray(img), 7.0, 20.0, bonus=1e4,
                                             interpret=True))
    _assert_same_corners(tfast.fast_score_dual_reference(t(img), 7.0, 20.0).numpy(), want)


@pytest.mark.parametrize("threshold", [7.0, 15.0, 20.0])
def test_fast_score_single_threshold(threshold):
    img = noise_image()
    want = np.asarray(jax.jit(jfast.fast_score, static_argnums=1)(jnp.asarray(img), threshold))
    got = tfast.fast_score(t(img), threshold).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_cpu_wrapper_is_the_plain_version():
    img = t(noise_image(64, 80))
    before = tfast.fast_dual_launches
    out = tfast.fast_score_dual(img, 7.0, 20.0)
    assert tfast.fast_dual_launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(out.numpy(), tfast.fast_score_dual_reference(img, 7.0, 20.0).numpy())


def test_fast_nms():
    s = tfast.fast_score_dual_reference(t(small_frame()[0]), 7.0, 20.0).numpy()
    want = np.asarray(jfast.fast_nms(jnp.asarray(s)))
    np.testing.assert_array_equal(tfast.fast_nms(t(s)).numpy(), want)


def test_shi_tomasi_min_eig():
    g = small_frame()[0]
    want = np.asarray(jfast.shi_tomasi_min_eig(jnp.asarray(g)))
    got = tfast.shi_tomasi_min_eig(t(g)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-5)


@pytest.mark.parametrize("budget", [40, 200])
def test_detect_grid_topk_level0(budget):
    """Identical keypoint (y, x) sets and responses at level 0."""
    g = small_frame()[0]
    jyx, jresp, jvalid = (np.asarray(a) for a in jfast.detect_grid_topk(
        jnp.asarray(g), 20.0, 7.0, 16, budget, 19))
    tyx, tresp, tvalid = (a.numpy() for a in tfast.detect_grid_topk(
        t(g), 20.0, 7.0, 16, budget, 19))
    np.testing.assert_array_equal(tvalid, jvalid)
    np.testing.assert_array_equal(tyx[tvalid], jyx[jvalid])
    np.testing.assert_allclose(tresp, jresp, atol=1e-4)
    assert tvalid.sum() > 10


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_batched_dual_reference_matches_pallas_vmap(stack):
    """K1b: the port's plain version on (S, H, W) against the TPU kernel's
    batched launch (`_dual_batched`, interpret mode)."""
    imgs = STACKS[stack]()
    want = np.asarray(jax.vmap(
        lambda im: fast_score_dual_pallas(im, 7.0, 20.0, bonus=1e4, interpret=True)
    )(jnp.asarray(imgs)))
    got = tfast.fast_score_dual_reference(t(imgs), 7.0, 20.0).numpy()
    assert got.shape == imgs.shape
    _assert_same_corners(got, want)
    for i in range(len(imgs)):  # each image of the stack as alone
        np.testing.assert_array_equal(got[i], tfast.fast_score_dual_reference(t(imgs[i]), 7.0, 20.0).numpy())


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_single_threshold_reference_matches_pallas(stack):
    """K2 on each image and K2b on the stack (`_score_2d` and, under
    `jax.vmap`, `_score_batched`, interpret mode), at the two thresholds."""
    imgs = STACKS[stack]()
    for th in (7.0, 20.0):
        want_b = np.asarray(jax.vmap(lambda im: fast_score_pallas(im, th, interpret=True))(jnp.asarray(imgs)))
        got_b = tfast.fast_score_reference(t(imgs), th).numpy()
        np.testing.assert_array_equal(got_b > 0, want_b > 0)
        np.testing.assert_allclose(got_b, want_b, atol=1e-4, rtol=0)
        want_1 = np.asarray(fast_score_pallas(jnp.asarray(imgs[0]), th, interpret=True))
        got_1 = tfast.fast_score(t(imgs[0]), th).numpy()
        np.testing.assert_array_equal(got_1 > 0, want_1 > 0)
        np.testing.assert_allclose(got_1, want_1, atol=1e-4, rtol=0)


def test_cpu_wrappers_launch_nothing():
    """On the CPU every FAST wrapper, batched or not, is its plain version."""
    imgs = t(np.stack([noise_image(40, 56, seed=s) for s in (1, 2)]))
    counts = lambda: (tfast.fast_dual_launches, tfast.fast_dual_batched_launches,  # noqa: E731
                      tfast.fast_score_launches, tfast.fast_score_batched_launches)
    before = counts()
    np.testing.assert_array_equal(tfast.fast_score_dual(imgs, 7.0, 20.0).numpy(),
                                  tfast.fast_score_dual_reference(imgs, 7.0, 20.0).numpy())
    np.testing.assert_array_equal(tfast.fast_score(imgs, 7.0).numpy(),
                                  tfast.fast_score_reference(imgs, 7.0).numpy())
    levels = tfast.pyramid_fast_scores(imgs, 7.0, 20.0, n_levels=3)
    assert [tuple(x.shape) for x in levels[::2]] == [(2, 40, 56), (2, 33, 47), (2, 28, 39)]
    assert counts() == before


def test_detect_grid_topk_batched_equals_single():
    """The detector on a (2, H, W) stack returns each image's own keypoints."""
    imgs = np.stack([g for g, _ in small_frames((2, 3))])
    got = tfast.detect_grid_topk(t(imgs), 20.0, 7.0, 16, 120, 19)
    for i in range(2):
        one = tfast.detect_grid_topk(t(imgs[i]), 20.0, 7.0, 16, 120, 19)
        for a, b in zip(got, one):
            np.testing.assert_array_equal(a[i].numpy(), b.numpy())


def _small_pyramid(stack=False):
    from hfvo_tpu_torch.ops import image as timg

    img = np.stack([g for g, _ in small_frames((2, 3))]) if stack else small_frame()[0]
    return [lvl.contiguous() for lvl in timg.build_pyramid(t(img), 8, 1.2)]


LEVEL_LISTS = {
    "frame_8_levels": lambda: _small_pyramid(),
    "stack_of_2_8_levels": lambda: _small_pyramid(stack=True),
    "ragged": lambda: [t(noise_image(7, 9, seed=1)), t(noise_image(33, 65, seed=2)), t(noise_image())],
}


@pytest.mark.parametrize("levels", sorted(LEVEL_LISTS))
def test_level_list_equals_reference_per_level(levels):
    """A list call returns one map a level, in the list's order and shape,
    with th_low and th_high in their places at both orders: the bonus marks
    the corners at th_high (one single-threshold list call), the rest are
    th_low's scores (another). The kernel's level table is held bit-equal
    to the plain version on the card (tests/test_torch_kernels.py)."""
    lvls = LEVEL_LISTS[levels]()
    for th_low, th_high in ((7.0, 20.0), (20.0, 7.0)):
        got = tfast.fast_score_dual_levels(lvls, th_low, th_high)
        low, high = tfast.fast_score_levels(lvls, th_low), tfast.fast_score_levels(lvls, th_high)
        assert len(got) == len(low) == len(high) == len(lvls)
        for g, lo, hi, x in zip(got, low, high, lvls):
            assert g.shape == lo.shape == hi.shape == x.shape
            assert hi.ne(0).any()
            np.testing.assert_array_equal(g.numpy(), torch.where(hi > 0, hi + 1e4, lo).numpy())


def test_level_list_refusals():
    """What no launch can take is refused on the CPU too; an empty list
    gives no maps, and a list longer than one launch's table is whole."""
    a, b = t(noise_image(20, 24)), t(noise_image(9, 12, seed=3))
    for bad in ([a, a[None]], [a, a.to("meta")], [a[0], a]):
        with pytest.raises(ValueError):
            tfast.fast_score_dual_levels(bad, 7.0, 20.0)
        with pytest.raises(ValueError):
            tfast.fast_score_levels(bad, 7.0)
    assert tfast.fast_score_dual_levels([], 7.0, 20.0) == [] == tfast.fast_score_levels([], 7.0)
    lvls = [a, b] * 8 + [t(noise_image(11, 13, seed=4))]
    got = tfast.fast_score_dual_levels(lvls, 7.0, 20.0)
    assert len(lvls) == tfast.MAX_LEVELS + 1 == len(got)
    assert [g.shape for g in got] == [x.shape for x in lvls]


def test_extract_orb_takes_more_than_16_levels():
    """n_levels = 17: more levels than one launch's table (two launches on
    the card); every level with a budget yields keypoints inside it."""
    from hfvo_tpu_torch.config import OrbConfig
    from hfvo_tpu_torch.ops import orb as torb

    cfg = OrbConfig(n_features=300, n_levels=17, scale_factor=1.05)
    f = torb.extract_orb(t(small_frame()[0]), cfg, 512)
    valid = f.valid.numpy()
    octs = f.octave.numpy()[valid]
    budgets = torb.level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    assert set(octs) == {l for l, n in enumerate(budgets) if n > 0}
    assert all((octs == l).sum() <= n for l, n in enumerate(budgets))
    uv = f.uv.numpy()[valid]
    assert np.isfinite(uv).all() and (uv >= 0).all() and (uv[:, 0] < 160).all() and (uv[:, 1] < 120).all()


@pytest.mark.parametrize("stack", [False, True])
def test_detect_grid_topk_takes_precomputed_scores(stack):
    img = t(np.stack([g for g, _ in small_frames((2, 3))]) if stack else small_frame()[0])
    comb = tfast.fast_score_dual_levels([img], 7.0, 20.0)[0]
    got = tfast.detect_grid_topk(img, 20.0, 7.0, 16, 120, 19, combined=comb)
    want = tfast.detect_grid_topk(img, 20.0, 7.0, 16, 120, 19)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_every_9_arc_passes_the_paired_cardinal_test():
    """Exhaustive over all 16-bit ring masks: a 9-arc (checked by brute
    force, and by the kernels' shift test) always holds ring position 0 or
    8 and position 4 or 12, so the kernels' early exit is exact."""
    m = np.arange(1 << 16, dtype=np.int64)
    bits = (m[:, None] >> np.arange(16)) & 1
    runs = np.stack([bits[:, (k + np.arange(9)) % 16].all(axis=1) for k in range(16)], axis=1)
    arc = runs.any(axis=1)
    np.testing.assert_array_equal(tfast._contiguous_arc(torch.from_numpy(m.astype(np.int32))).numpy(), arc)
    assert arc.sum() == 1025
    paired = (bits[:, 0] | bits[:, 8]) & (bits[:, 4] | bits[:, 12])
    assert paired[arc].all()


@pytest.mark.parametrize("ths", [(7.0, 20.0), (20.0, 7.0)])
@pytest.mark.parametrize("images", ["frame_8_levels", "noise_250x330"])
def test_early_reject_keeps_every_corner(images, ths):
    """The plain mirror of the kernels' pre-test at min(th_low, th_high)
    passes every pixel with a nonzero score, dual or at that threshold."""
    lvls = _small_pyramid() if images == "frame_8_levels" else [t(noise_image())]
    th_min = min(ths)
    n_cand = n_px = 0
    for x in lvls:
        cand = tfast.fast_candidates_reference(x, th_min)
        for score in (tfast.fast_score_dual_reference(x, *ths), tfast.fast_score_reference(x, th_min)):
            assert score.ne(0).any()
            assert not (score.ne(0) & ~cand).any()
        n_cand, n_px = n_cand + int(cand.sum()), n_px + x.numel()
    if images == "frame_8_levels":
        assert n_cand < 0.75 * n_px  # it rejects pixels (58 % pass at 120x160)
