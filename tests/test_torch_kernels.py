"""The port's CUDA kernels against their plain versions, on the card.

This file imports no JAX, so it runs on a machine with a GPU and no JAX
(tests/conftest.py imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -o addopts= -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Without a GPU every test here skips.

K1 (`fast_score_dual` on an (H, W) image), K1b (on an (S, H, W) stack), K2
and K2b (`fast_score`, the single-threshold instantiation of the same
source): identical corner masks (score > 0 and score > the
1e4 bonus), values within atol 2e-3 and no relative slack: 2 ulp for every
score past the bonus (float32's ulp is 2**-10 over [8192, 16384)). Both sides add the same
terms in the same order without multiplies, so the kernel has measured
bit-equal; the 2 ulp leave room only for a reordering of the sums. Checked at
the 8 pyramid levels of a rendered 480x640 frame and on 250x330 noise.

K3 (`hough_vote`): |kernel - plain| / max(|plain|, 1) <= 1e-4 and the same
top-4 bins in every tile whose 4th and 5th plain values are more than 1e-4
apart. Shared-memory float atomics add the votes in an order that changes
from run to run, so the sums agree to float32 rounding and not bit for bit;
the theta and rho bins are computed without FMA contraction, so every vote
lands in the plain version's bin. Checked on the 70 tiles of a rendered
480x640 frame and the 15 tiles of 250x330 noise; K3b (`hough_vote` on an
(S, H, W) stack) the same on the 560 tiles of 8 rendered frames.

The batched kernels are checked at the batch path's shapes: the 8 pyramid
levels of 8 rendered 480x640 frames stacked as (8, h_l, w_l), and their
Sobel magnitude and angle as (8, 480, 640). Every launch counts once,
whatever S is and however many levels its table holds (the FAST kernels
score up to 16 levels a launch)."""
import numpy as np
import pytest
import torch

from hfvo_tpu_torch.ops import fast as tfast
from hfvo_tpu_torch.ops import image as timg
from hfvo_tpu_torch.ops import lines as tlines
from torch_helpers import cuda_device, noise_image  # noqa: F401


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(cuda_device):
    from hfvo_tpu_torch.testing import synthetic

    _, grays, _ = synthetic.render_sequence(n=1, seed=0, device=cuda_device)
    imgs = timg.build_pyramid(torch.from_numpy(grays[0]).to(cuda_device), 8, 1.2)
    imgs.append(torch.from_numpy(noise_image()).to(cuda_device))
    before = tfast.fast_dual_launches
    for img in imgs:
        img = img.contiguous()
        got = tfast.fast_score_dual(img, 7.0, 20.0)
        want = tfast.fast_score_dual_reference(img, 7.0, 20.0)
        torch.cuda.synchronize()
        got, want = got.cpu().numpy(), want.cpu().numpy()
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_array_equal(got > 1e4, want > 1e4)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert tfast.fast_dual_launches == before + len(imgs)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs_on_card(cuda_device):
    img = torch.zeros((32, 40), device=cuda_device)
    before = tfast.fast_dual_launches
    for bad in (img.double(), img[None, None], img.t()):
        with pytest.raises(ValueError):
            tfast.fast_score_dual(bad, 7.0, 20.0)
        with pytest.raises(ValueError):
            tfast.fast_score(bad, 7.0)
    assert tfast.fast_dual_launches == before


def _grad_images(img):
    gx, gy = timg.sobel_gradients(img)
    return torch.sqrt(gx * gx + gy * gy), torch.remainder(torch.atan2(gy, gx), torch.pi)


@pytest.mark.cuda
def test_hough_vote_matches_plain_version_on_card(cuda_device):
    from hfvo_tpu_torch.testing import synthetic

    _, grays, _ = synthetic.render_sequence(n=1, seed=0, device=cuda_device)
    frame = torch.from_numpy(np.clip(grays[0], 0, 255).astype(np.uint8)).to(cuda_device).float()
    before = tlines.hough_vote_launches
    for img, n_tiles in ((frame, 70), (torch.from_numpy(noise_image()).to(cuda_device), 15)):
        mag, ang = _grad_images(img)
        got = tlines.hough_vote(mag, ang, 12.0)
        want = tlines.hough_vote_reference(mag, ang, 12.0)
        torch.cuda.synchronize()
        got, want = got.cpu().numpy(), want.cpu().numpy()
        assert got.shape == want.shape == (n_tiles, tlines.N_THETA, tlines.N_RHO)
        assert (np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max() <= 1e-4
        for k in range(n_tiles):
            w, g = want[k].ravel(), got[k].ravel()
            srt = np.sort(w)[::-1]
            if srt[3] - srt[4] > 1e-4 * max(abs(srt[3]), 1.0):
                assert set(np.argsort(w)[-4:]) == set(np.argsort(g)[-4:])
    assert tlines.hough_vote_launches == before + 2


@pytest.mark.cuda
def test_hough_vote_rejects_bad_inputs_on_card(cuda_device):
    img = torch.zeros((128, 192), device=cuda_device)
    before = tlines.hough_vote_launches
    for bad in (img.double(), img[None, None], img.t()):
        with pytest.raises(ValueError):
            tlines.hough_vote(bad, bad, 12.0)
    with pytest.raises(ValueError):
        tlines.hough_vote(img, img[:64], 12.0)
    assert tlines.hough_vote_launches == before


def _assert_same_corners(got, want, bonus=True):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    if bonus:
        np.testing.assert_array_equal(got > 1e4, want > 1e4)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def _frames_u8(device, n=8):
    from hfvo_tpu_torch.testing import synthetic

    _, grays, _ = synthetic.render_sequence(n=n, seed=0, device=device)
    return torch.from_numpy(np.clip(np.stack(grays), 0, 255).astype(np.uint8)).to(device).float()


@pytest.mark.cuda
def test_batched_fast_kernels_match_plain_versions_on_card(cuda_device):
    """K1b and K2b on the 8 pyramid levels of 8 frames, each level one
    launch; K2 on each level of one frame."""
    levels = timg.build_pyramid(_frames_u8(cuda_device), 8, 1.2)
    counts = (tfast.fast_dual_batched_launches, tfast.fast_score_batched_launches,
              tfast.fast_score_launches)
    for lvl in levels:
        lvl = lvl.contiguous()
        assert lvl.shape[0] == 8
        _assert_same_corners(tfast.fast_score_dual(lvl, 7.0, 20.0),
                             tfast.fast_score_dual_reference(lvl, 7.0, 20.0))
        for th in (7.0, 20.0):
            _assert_same_corners(tfast.fast_score(lvl, th), tfast.fast_score_reference(lvl, th),
                                 bonus=False)
            one = lvl[3].contiguous()
            _assert_same_corners(tfast.fast_score(one, th), tfast.fast_score_reference(one, th),
                                 bonus=False)
    assert (tfast.fast_dual_batched_launches, tfast.fast_score_batched_launches,
            tfast.fast_score_launches) == (counts[0] + 8, counts[1] + 16, counts[2] + 16)


@pytest.mark.cuda
def test_batched_hough_vote_matches_plain_version_on_card(cuda_device):
    mag, ang = _grad_images(_frames_u8(cuda_device))
    before = tlines.hough_vote_batched_launches
    got = tlines.hough_vote(mag.contiguous(), ang.contiguous(), 12.0)
    want = tlines.hough_vote_reference(mag, ang, 12.0)
    torch.cuda.synchronize()
    assert tlines.hough_vote_batched_launches == before + 1
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.shape == want.shape == (8, 70, tlines.N_THETA, tlines.N_RHO)
    assert (np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max() <= 1e-4
    for s in range(8):
        for k in range(70):
            w, g = want[s, k].ravel(), got[s, k].ravel()
            srt = np.sort(w)[::-1]
            if srt[3] - srt[4] > 1e-4 * max(abs(srt[3]), 1.0):
                assert set(np.argsort(w)[-4:]) == set(np.argsort(g)[-4:])
    # Each image of the stack is voted exactly as alone (same bins; the
    # atomics' order may differ).
    single = tlines.hough_vote(mag[5].contiguous(), ang[5].contiguous(), 12.0).cpu().numpy()
    assert (np.abs(single - got[5]) / np.maximum(np.abs(got[5]), 1.0)).max() <= 1e-4


def _fast_counts():
    return (tfast.fast_dual_launches, tfast.fast_dual_batched_launches,
            tfast.fast_score_launches, tfast.fast_score_batched_launches)


@pytest.mark.cuda
def test_level_table_matches_plain_version_per_level_on_card(cuda_device):
    """One launch over a list of levels equals each level's plain version:
    one frame's pyramid (K1, K2), the stack of 8 (K1b, K2b), a ragged list
    with levels narrower than a tile and 250x330 noise, and 17 levels (two
    launches: a table holds 16); both threshold orders."""
    frames = _frames_u8(cuda_device)
    noise = torch.from_numpy(noise_image()).to(cuda_device)
    ragged = [torch.from_numpy(noise_image(h, w, seed=s)).to(cuda_device)
              for s, (h, w) in enumerate(((7, 9), (33, 65), (5, 400), (300, 20)))] + [noise]
    lists = {
        "frame": [lvl.contiguous() for lvl in timg.build_pyramid(frames[0], 8, 1.2)],
        "stack": [lvl.contiguous() for lvl in timg.build_pyramid(frames, 8, 1.2)],
        "ragged": ragged,
    }
    lists["17_levels"] = lists["frame"] + ragged + ragged[:4]
    for name, lvls in lists.items():
        batched = lvls[0].dim() == 3
        n = -(-len(lvls) // tfast.MAX_LEVELS)
        for th_low, th_high in ((7.0, 20.0), (20.0, 7.0)):
            before = _fast_counts()
            got = tfast.fast_score_dual_levels(lvls, th_low, th_high)
            single = tfast.fast_score_levels(lvls, th_low)
            torch.cuda.synchronize()
            want = (n, 0, n, 0) if not batched else (0, n, 0, n)
            assert tuple(a - b for a, b in zip(_fast_counts(), before)) == want, name
            for g, o, x in zip(got, single, lvls):
                _assert_same_corners(g, tfast.fast_score_dual_reference(x, th_low, th_high))
                _assert_same_corners(o, tfast.fast_score_reference(x, th_low), bonus=False)


@pytest.mark.cuda
def test_level_table_s1_equals_2d_on_card(cuda_device):
    lvls = [lvl.contiguous() for lvl in timg.build_pyramid(_frames_u8(cuda_device, n=1)[0], 8, 1.2)]
    flat = tfast.fast_score_dual_levels(lvls, 7.0, 20.0)
    one = tfast.fast_score_dual_levels([x[None] for x in lvls], 7.0, 20.0)
    torch.cuda.synchronize()
    for a, b in zip(flat, one):
        assert b.shape[0] == 1
        assert torch.equal(a, b[0])


@pytest.mark.cuda
def test_level_table_refusals_on_card(cuda_device):
    """ValueError, and no launch, for what the kernel cannot take; an empty
    list launches nothing."""
    a = torch.zeros((40, 56), device=cuda_device)
    bad_lists = (
        [a[None].expand(2, 40, 56).contiguous(), a[None]],  # different S
        [a, a.t()],                                         # non-contiguous
        [a, a.double()],                                    # float64
        [a, a.cpu()],                                       # two devices
        [a.cpu(), a],
    )
    before = _fast_counts()
    for bad in bad_lists:
        with pytest.raises(ValueError):
            tfast.fast_score_dual_levels(bad, 7.0, 20.0)
        with pytest.raises(ValueError):
            tfast.fast_score_levels(bad, 7.0)
    assert tfast.fast_score_dual_levels([], 7.0, 20.0) == [] == tfast.fast_score_levels([], 7.0)
    assert _fast_counts() == before
