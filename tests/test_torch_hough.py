"""The exact bins of the Hough-vote kernels K3 and K3b (csrc/hough_vote.cu),
on the CPU and without JAX.

The kernel computes no division: its theta bin is the guess
int(angle * (36 / pi)) corrected by one step against the host's edge table
(`lines.theta_edges`), and its rho bin is int(rho * (24 / diag) + 24).
These tests hold both to the plain version's bins (`lines._theta_bin`,
`lines._rho_bin`, what `hough_vote_reference` votes with), exactly:

- theta: 10**6 seeded uniform angles in [0, pi) and the 4,001 float32s
  within 2,000 ulps of each of the 35 inner edges, through a numpy float32
  mirror of the kernel's arithmetic and through `lines.theta_bin_kernel`;
- rho: every one of the 64 x 64 x 36 (x, y, theta row) triples the kernel
  can meet, in numpy float32 with each step rounded (no FMA, as the
  kernel's intrinsics);
- the whole vote: `lines.vote_bins` with the kernel's mirrors against the
  plain bins on a rendered 480x640 frame.
"""
import math

import numpy as np
import torch

from hfvo_tpu_torch.ops import image as timg
from hfvo_tpu_torch.ops import lines as tl

f32 = np.float32


def _kernel_theta_bin(a: np.ndarray) -> np.ndarray:
    """csrc/hough_vote.cu::theta_bin in numpy float32."""
    edges = tl.kernel_table()[2 * tl.N_THETA:]
    with np.errstate(invalid="ignore", over="ignore"):
        tb = np.clip((a * tl.THETA_SCALE).astype(np.int32), 0, tl.N_THETA - 1)
    return np.minimum(tb - (a < edges[tb]) + (a >= edges[tb + 1]), tl.N_THETA - 1)


def test_kernel_table_layout():
    tab = tl.kernel_table()
    assert tab.dtype == np.float32 and tab.shape == (3 * tl.N_THETA + 1,)
    np.testing.assert_array_equal(tab[: 2 * tl.N_THETA], tl.theta_table().ravel())
    edges = tab[2 * tl.N_THETA:]
    assert edges[0] == -np.inf and edges[-1] == np.inf
    assert np.all(np.diff(edges) > 0)
    # The kernel's constants, as its source computes them in double and
    # rounds once.
    assert tl.THETA_SCALE == f32(36.0 / math.pi)
    assert tl.RHO_SCALE == f32(24.0 / (64.0 * math.sqrt(2.0)))


def test_theta_edges_are_the_least_angles_of_their_bins():
    inner = tl.theta_edges()[1:-1]
    below = np.nextafter(inner, f32(-np.inf))
    k = np.arange(1, tl.N_THETA)
    np.testing.assert_array_equal(tl._theta_bin(torch.from_numpy(inner)).numpy(), k)
    np.testing.assert_array_equal(tl._theta_bin(torch.from_numpy(below)).numpy(), k - 1)


def test_kernel_theta_bin_equals_plain_bin():
    uniform = np.random.default_rng(0).uniform(0, np.pi, 1_000_000).astype(np.float32)
    bits = tl.theta_edges()[1:-1].view(np.int32)
    near = (bits[:, None] + np.arange(-2000, 2001, dtype=np.int32)).view(np.float32).ravel()
    odd = np.array([0.0, -0.0, -1e-30, -1.0, np.pi, 3.5, 100.0, 1e6], np.float32)
    a = np.concatenate([uniform, near, odd])
    want = tl._theta_bin(torch.from_numpy(a)).numpy()
    with np.errstate(invalid="ignore", over="ignore"):
        guess = np.clip((a * tl.THETA_SCALE).astype(np.int32), 0, tl.N_THETA - 1)
    assert np.abs(guess - want).max() <= 1  # one correction step suffices
    np.testing.assert_array_equal(_kernel_theta_bin(a), want)
    np.testing.assert_array_equal(tl.theta_bin_kernel(torch.from_numpy(a)).numpy(), want)
    # Where the plain version's float-to-int cast is undefined, the kernel's
    # bin still lies in the accumulator.
    bad = np.array([np.inf, -np.inf, np.nan, 3e38, -3e38], np.float32)
    for got in (_kernel_theta_bin(bad), tl.theta_bin_kernel(torch.from_numpy(bad)).numpy()):
        assert ((got >= 0) & (got < tl.N_THETA)).all()


def test_kernel_rho_bin_equals_plain_bin_on_every_triple():
    cos, sin = tl.theta_table()
    x = np.arange(tl.TILE, dtype=np.float32)
    X, Y, T = np.meshgrid(x, x, np.arange(tl.N_THETA), indexing="ij")
    rho = X * cos[T] + Y * sin[T]  # float32 products, then a float32 sum
    assert rho.dtype == np.float32 and rho.size == 147_456
    want = tl._rho_bin(torch.from_numpy(rho)).numpy()
    got = np.clip((rho * tl.RHO_SCALE + f32(tl.N_RHO // 2)).astype(np.int32), 0, tl.N_RHO - 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tl.rho_bin_kernel(torch.from_numpy(rho)).numpy(), want)


def test_kernel_bins_equal_plain_bins_on_rendered_frame():
    from hfvo_tpu_torch.testing import synthetic

    _, grays, _ = synthetic.render_sequence(n=1, seed=0)
    img = torch.from_numpy(np.clip(grays[0], 0, 255).astype(np.uint8).astype(np.float32))
    gx, gy = timg.sobel_gradients(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = tl.to_tiles(torch.remainder(torch.atan2(gy, gx), math.pi))
    assert ang.shape == (70, tl.TILE * tl.TILE)
    assert int((tl.to_tiles(mag) > 12.0).sum()) > 10_000
    want = tl.vote_bins(ang)
    got = tl.vote_bins(ang, tl.theta_bin_kernel, tl.rho_bin_kernel)
    for (gt, gr), (wt, wr) in zip(got, want):
        assert torch.equal(gt, wt) and torch.equal(gr, wr)
