"""Flow-based line recovery: `warp_points_by_rotation`, `dense_flow_half`
and `recover_lines_by_flow` against hfvo_tpu's on the same numpy inputs
(CPU), on two consecutive frames of the renderer's orbit at 240x320.

The JAX package computes the flow's cost volume in bfloat16 on every
backend (hfvo_tpu/ops/lk.py:164-173) and bounds the effect at 0.3 px of
flow, 0.02 px on average; the port computes it in float32. So the flow is
held to that bound, and each recovered segment's line to the same 0.3 px,
with the same recovered set; its endpoints may move along the line by one
sample spacing (|p1 - p0| / 16), where a sample's photometric gate flips.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfvo_tpu.ops import lines as jl
from hfvo_tpu.ops import lk as jlk
from hfvo_tpu_torch.ops import lk as tlk
from torch_helpers import small_intrinsics, t

H, W = 240, 320


def _intr():
    c = small_intrinsics()
    s = W / c.width
    return c._replace(fx=c.fx * s, fy=c.fy * s, cx=c.cx * s, cy=c.cy * s, bf=c.bf * s,
                      width=W, height=H)


@pytest.fixture(scope="module")
def pair():
    """(img0, img1, R_10) for frames 3 and 4 of the orbit at 240x320."""
    from hfvo_tpu_torch.testing import synthetic

    T_wc = synthetic.orbit_trajectory(6)
    room = synthetic.make_room(0)
    imgs = [synthetic.render(room, _intr(), torch.from_numpy(T_wc[k]))[0].numpy() for k in (3, 4)]
    T_10 = np.linalg.inv(T_wc[4]) @ T_wc[3]
    return imgs[0], imgs[1], T_10[:3, :3].astype(np.float32)


def test_warp_points_by_rotation_matches_jax(pair):
    *_, R = pair
    uv = np.random.default_rng(0).uniform(0, 300, (64, 2)).astype(np.float32)
    intr = _intr()
    want = np.asarray(jlk.warp_points_by_rotation(intr, jnp.asarray(uv), jnp.asarray(R)))
    got = tlk.warp_points_by_rotation(intr, t(uv), t(R)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-6)


def test_dense_flow_half_within_the_bf16_bound(pair):
    img0, img1, _ = pair
    fj, cj = (np.asarray(a) for a in jlk.dense_flow_half(jnp.asarray(img0), jnp.asarray(img1)))
    ft, ct = (a.numpy() for a in tlk.dense_flow_half(t(img0), t(img1)))
    assert ft.shape == fj.shape == (H // 2, W // 2, 2)
    err = np.abs(ft - fj)
    assert err.max() <= 0.3 and err.mean() <= 0.02, (err.max(), err.mean())
    assert np.abs(fj).mean() > 0.5  # the pair does move
    # conf is a box-summed SAD / 121: bf16 rounds the sums by ~0.4 %.
    np.testing.assert_allclose(ct, cj, rtol=2e-2, atol=0.2)


def test_box_sum_is_the_banded_sum():
    C = torch.from_numpy(np.random.default_rng(1).uniform(0, 9, (3, 17, 13)).astype(np.float32))
    for dim, n in ((1, 17), (2, 13)):
        i = np.arange(n)
        band = torch.from_numpy((np.abs(i[:, None] - i[None, :]) <= 5).astype(np.float32))
        want = torch.einsum("ij,djw->diw", band, C) if dim == 1 else torch.einsum("dhj,jw->dhw", C, band)
        torch.testing.assert_close(tlk._box_sum(C, 5, dim), want, atol=1e-4, rtol=1e-5)


def test_recover_lines_by_flow_matches_jax(pair):
    img0, img1, R = pair
    lf = jl.detect_lines(jnp.asarray(img0), capacity=64)
    p0, p1, valid = (np.asarray(a) for a in (lf.p0, lf.p1, lf.valid))
    intr = _intr()
    want = [np.asarray(a) for a in jlk.recover_lines_by_flow(
        intr, jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(p0), jnp.asarray(p1),
        jnp.asarray(valid), jnp.asarray(R))]
    got = [a.numpy() for a in tlk.recover_lines_by_flow(
        intr, t(img0), t(img1), t(p0), t(p1), t(valid), t(R))]
    ok = want[2]
    assert ok.sum() >= 5
    np.testing.assert_array_equal(got[2], ok)
    # The fitted line within the flow bound; each endpoint along it within
    # one sample spacing (a sample whose gate flips moves the extent by one).
    q0w, q1w, q0g, q1g = want[0][ok], want[1][ok], got[0][ok], got[1][ok]
    u = (q1w - q0w) / np.linalg.norm(q1w - q0w, axis=1, keepdims=True)
    n = np.stack([-u[:, 1], u[:, 0]], axis=1)
    spacing = np.linalg.norm(p1 - p0, axis=1)[ok] / 16
    for qg, qw in ((q0g, q0w), (q1g, q1w)):
        assert np.abs(np.sum((qg - q0w) * n, axis=1)).max() <= 0.3
        assert (np.abs(np.sum((qg - qw) * u, axis=1)) <= spacing + 0.3).all()

