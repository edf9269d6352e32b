"""The points-only slice as a whole: hfvo_tpu's Tracker and the port's on
the same frames and configuration (tum3, use_lines/planes/manhattan off, no
triangulation, local BA and loop closing off).

(a) JAX and port over 8 frames: per-frame pose within 2 mm and 0.1 deg,
    and the same keyframe decisions. Independent runs drift apart only by
    float32 rounding in extraction and the LM.
(b) One fused step from a map carried across with tracker_state_from_numpy:
    the same pose within 1e-4 and the same inlier count.
(c) The port alone over render_sequence(n=25, seed=0): 0 LOST frames and
    ATE <= 0.0125 m (1.5x the JAX package's 0.0083 m on this run).
The frames come from the port's renderer, which is held to JAX's `render`
on one frame (gray within 1e-3, depth within 1e-5 m)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.testing import synthetic as jsyn
from hfvo_tpu.tracking.tracker import Tracker as JaxTracker
from hfvo_tpu_torch import convert
from hfvo_tpu_torch.config import points_only, tum3_config
from hfvo_tpu_torch.io import evaluate
from hfvo_tpu_torch.system import VOSystem
from hfvo_tpu_torch.testing import synthetic as tsyn
from hfvo_tpu_torch.tracking.tracker import Tracker, TrackState
import torch_helpers  # noqa: F401  (test thread policy)

N_PARITY = 8
ATE_GATE = 0.0125


def _jax_cfg():
    c = jax_tum3()
    return c.replace(
        use_lines=False, use_planes=False, use_manhattan=False,
        tracking=dataclasses.replace(c.tracking, triangulate_new_points=False,
                                     triangulate_new_lines=False),
    )


def _port_tracker():
    return Tracker(points_only(tum3_config()), "cpu", use_local_ba=False, use_loop_closing=False)


@pytest.fixture(scope="module")
def frames():
    return tsyn.render_sequence(n=25, seed=0)


@pytest.fixture(scope="module")
def port_run(frames):
    """The port over all 25 frames through VOSystem: (T_cw per frame,
    keyframe flags, states, trajectory T_wc)."""
    T_wc, grays, depths = frames
    system = VOSystem(points_only(tum3_config()), "cpu", use_local_ba=False,
                      use_loop_closing=False)
    system.tracker.T_cw = np.linalg.inv(T_wc[0]).astype(np.float32)
    poses, kfs, states = [], [], []
    for i, (g, d) in enumerate(zip(grays, depths)):
        res = system.track_rgbd(g, d, i / 30.0)
        poses.append(res.T_cw)
        kfs.append(res.is_keyframe)
        states.append(res.state)
    return np.stack(poses), kfs, states, system.get_trajectory()


@pytest.fixture(scope="module")
def jax_run(frames):
    """hfvo_tpu's Tracker over the first N_PARITY frames; returns the poses,
    keyframe flags and the tracker itself (its state is carried in (b))."""
    T_wc, grays, depths = frames
    tr = JaxTracker(_jax_cfg(), use_local_ba=False, use_loop_closing=False)
    poses, kfs = [], []
    for g, d in zip(grays[:N_PARITY], depths[:N_PARITY]):
        res = tr.track_rgbd(g, d, T_cw_init=np.linalg.inv(T_wc[0]))
        poses.append(res.T_cw)
        kfs.append(res.is_keyframe)
    return np.stack(poses), kfs, tr


def test_renderer_matches_jax(frames):
    T_wc, grays, depths = frames
    g, d = jsyn.render(jsyn.make_room(0), jax_tum3().camera, jnp.asarray(T_wc[5]))
    np.testing.assert_allclose(grays[5], np.asarray(g), atol=1e-3, rtol=0)
    np.testing.assert_allclose(depths[5], np.asarray(d), atol=1e-5, rtol=0)
    np.testing.assert_allclose(T_wc, jsyn.orbit_trajectory(25), atol=1e-6)


def _pose_gap(Ta, Tb):
    D = Ta @ np.linalg.inv(Tb)
    rot = np.degrees(np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)))
    return np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]), rot


def test_a_per_frame_parity_with_jax(port_run, jax_run):
    p_poses, p_kfs, _, _ = port_run
    j_poses, j_kfs, _ = jax_run
    assert p_kfs[:N_PARITY] == j_kfs
    for i in range(N_PARITY):
        dt, dr = _pose_gap(p_poses[i], j_poses[i])
        assert dt < 2e-3 and dr < 0.1, f"frame {i}: {dt * 1e3:.3f} mm, {dr:.4f} deg"


def test_b_step_from_carried_map(frames, jax_run):
    T_wc, grays, depths = frames
    _, _, jt = jax_run
    state = convert.tracker_state_numpy(jt)
    pt = _port_tracker()
    convert.tracker_state_from_numpy(pt, state)
    want = jt.track_rgbd(grays[N_PARITY], depths[N_PARITY])
    got = pt.track_rgbd(grays[N_PARITY], depths[N_PARITY])
    assert got.state is TrackState.OK and want.state.name == "OK"
    np.testing.assert_allclose(got.T_cw, want.T_cw, atol=1e-4, rtol=0)
    assert got.n_matches == want.n_matches
    assert got.is_keyframe == want.is_keyframe


def test_c_port_tracks_sequence(frames, port_run):
    T_wc, _, _ = frames
    _, kfs, states, est = port_run
    assert all(s is TrackState.OK for s in states)
    ts = np.arange(len(est)) / 30.0
    ape = evaluate.ate(ts, T_wc, ts, est, align="origin")
    assert ape.rmse <= ATE_GATE, f"ATE RMSE {ape.rmse:.4f} m"
    assert 2 <= sum(kfs) <= 8


def test_state_round_trip(frames):
    """tracker_state_numpy -> tracker_state_from_numpy reproduces the port's
    own state exactly."""
    T_wc, grays, depths = frames
    a = _port_tracker()
    for g, d in zip(grays[:3], depths[:3]):
        a.track_rgbd(g, d, T_cw_init=np.linalg.inv(T_wc[0]))
    b = _port_tracker()
    convert.tracker_state_from_numpy(b, convert.tracker_state_numpy(a))
    sa, sb = convert.tracker_state_numpy(a), convert.tracker_state_numpy(b)
    for name, fields in sa["tables"].items():
        for key, val in fields.items():
            np.testing.assert_array_equal(sb["tables"][name][key], val, err_msg=f"{name}.{key}")
    assert sa["frame_id"] == sb["frame_id"] and sa["state"] == sb["state"]
    np.testing.assert_array_equal(b.get_trajectory(), a.get_trajectory())


def test_featureless_frame_resets_infant_map(frames):
    """A blank frame right after init: both retries fail with no keypoints,
    so the reference-keyframe fallback cannot match either; the tracker is
    LOST and, with <= 5 keyframes, auto-resets (Tracking.cc:918-926) and
    re-initializes on the next frame."""
    T_wc, grays, depths = frames
    tr = _port_tracker()
    tr.track_rgbd(grays[0], depths[0], T_cw_init=np.linalg.inv(T_wc[0]))
    res = tr.track_rgbd(np.full_like(grays[1], 128.0), depths[1])
    assert res.state is TrackState.NOT_INITIALIZED  # LOST, then reset
    assert tr.vomap.n_keyframes() == 0
    res = tr.track_rgbd(grays[2], depths[2], T_cw_init=np.linalg.inv(T_wc[2]))
    assert res.state is TrackState.OK and res.is_keyframe
    assert len(tr.get_trajectory()) == 3


def test_system_saves_tum_trajectory(port_run, tmp_path):
    from hfvo_tpu_torch.io import trajectory

    *_, est = port_run
    path = tmp_path / "traj.txt"
    trajectory.save_tum(str(path), list(np.arange(len(est)) / 30.0), est)
    ts, T = trajectory.load_tum(str(path))
    assert len(ts) == len(est)
    np.testing.assert_allclose(T[:, :3, 3], est[:, :3, 3], atol=1e-5)


def test_cpu_run_does_not_launch_the_kernel(port_run):
    from hfvo_tpu_torch.ops import fast

    assert fast.fast_dual_launches == 0
