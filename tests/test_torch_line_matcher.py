"""Line matching: `search_lines_by_projection` and `search_lines_f2f`
against hfvo_tpu's on shared inputs (CPU): the same match per segment and
the same visibility. Map lines are the depth-fitted 3D lines of frame 3 of
the renderer's orbit at 240x320; the searched segments are those of frame 4.
Both sides quantize the cosine distance to thousandths, so a float32 sum
order can only move a match where a distance sits on a thousandth's edge."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfvo_tpu.ops import lines as jl
from hfvo_tpu.ops import lines3d as jl3
from hfvo_tpu.ops import lk as jlk
from hfvo_tpu.tracking import matcher as jm
from hfvo_tpu_torch.ops import lk as tlk
from hfvo_tpu_torch.tracking import matcher as tm
from test_torch_lk import _intr
from torch_helpers import t


@pytest.fixture(scope="module")
def scene():
    from hfvo_tpu_torch.testing import synthetic

    T_wc = synthetic.orbit_trajectory(8)
    room = synthetic.make_room(0)
    intr = _intr()
    frames = {k: [a.numpy() for a in synthetic.render(room, intr, torch.from_numpy(T_wc[k]))]
              for k in (3, 5)}
    lf3 = jl.detect_lines(jnp.asarray(frames[3][0]), capacity=64)
    lf5 = jl.detect_lines(jnp.asarray(frames[5][0]), capacity=64)
    l3d = jl3.fit_lines_3d(jnp.asarray(frames[3][1]), intr, lf3.p0, lf3.p1, lf3.valid)
    R, tw = T_wc[3][:3, :3], T_wc[3][:3, 3]
    X0 = (np.asarray(l3d.X0_c) @ R.T + tw).astype(np.float32)
    X1 = (np.asarray(l3d.X1_c) @ R.T + tw).astype(np.float32)
    mvalid = np.array(l3d.valid & lf3.valid)
    mvalid[::7] = False
    lf3 = [np.asarray(a) for a in lf3]
    lf5 = [np.asarray(a) for a in lf5]
    return intr, T_wc, X0, X1, mvalid, lf3, lf5


def test_search_lines_by_projection_matches_jax(scene):
    intr, T_wc, X0, X1, mvalid, lf3, lf5 = scene
    T_cw = np.linalg.inv(T_wc[5]).astype(np.float32)
    want = jm.search_lines_by_projection(
        jnp.asarray(X0), jnp.asarray(X1), jnp.asarray(lf3[4]), jnp.asarray(mvalid),
        jnp.asarray(lf5[0]), jnp.asarray(lf5[1]), jnp.asarray(lf5[4]), jnp.asarray(lf5[5]),
        jnp.asarray(T_cw), intr,
    )
    got = tm.search_lines_by_projection(
        t(X0), t(X1), t(lf3[4]), t(mvalid), t(lf5[0]), t(lf5[1]), t(lf5[4]), t(lf5[5]),
        t(T_cw), intr,
    )
    assert int(want.n_matches) >= 5
    np.testing.assert_array_equal(got.pt_id_per_kp.numpy(), np.asarray(want.pt_id_per_kp))
    np.testing.assert_array_equal(got.visible.numpy(), np.asarray(want.visible))
    assert int(got.n_matches) == int(want.n_matches)


def test_search_lines_f2f_matches_jax(scene):
    intr, T_wc, _, _, _, lf3, lf5 = scene
    R_cl = (np.linalg.inv(T_wc[5]) @ T_wc[3])[:3, :3].astype(np.float32)
    w = [np.asarray(jlk.warp_points_by_rotation(intr, jnp.asarray(p), jnp.asarray(R_cl)))
         for p in (lf3[0], lf3[1])]
    np.testing.assert_allclose(tlk.warp_points_by_rotation(intr, t(lf3[0]), t(R_cl)).numpy(),
                               w[0], atol=1e-3)
    prev_valid = lf3[5].copy()
    prev_valid[1::5] = False
    want = jm.search_lines_f2f(
        jnp.asarray(w[0]), jnp.asarray(w[1]), jnp.asarray(lf3[4]), jnp.asarray(prev_valid),
        jnp.asarray(lf5[0]), jnp.asarray(lf5[1]), jnp.asarray(lf5[4]), jnp.asarray(lf5[5]),
    )
    got = tm.search_lines_f2f(
        t(w[0]), t(w[1]), t(lf3[4]), t(prev_valid), t(lf5[0]), t(lf5[1]), t(lf5[4]), t(lf5[5]),
    )
    assert int(want.n_matches) >= 5
    np.testing.assert_array_equal(got.pt_id_per_kp.numpy(), np.asarray(want.pt_id_per_kp))
    assert int(got.n_matches) == int(want.n_matches)
