"""The batch slice as a whole: S sequences through one batched fused step
(hfvo_tpu_torch.parallel.multiseq.BatchTracker), point + line tracking on
tum3 (planes, Manhattan and triangulation off, local BA off).

(a) One batched step against S single steps. From S = 3 tracker states
    built by 3 single-sequence frames of orbits with seeds 0, 7 and 3, one
    batched step (snapshots of different lengths, padded) against each
    sequence's own S = 1 step: poses within 1e-5 and identical point and
    line matches, inliers and recovered rows. The largest pose gap measured
    on the CPU is 3e-7. The pose LM alone, on 3 scenes started from
    different poses with different point noise, visits per sequence the
    (pose, lambda) sequence it visits alone, read at three prefixes. These
    catch cross-talk between sequences.
(b) hfvo_tpu's BatchTracker against the port's, n_seq = 2, seeds (0, 7):
    the JAX batch tracks frames 0-1, its two tracker states are carried
    across (frame 0 looks straight at a wall, where the 3D line order is
    rounding noise; ROADMAP queue 3), then both track frames 2-5 as a
    batch: per-frame pose within 2 mm and 0.1 deg, the same keyframe
    decisions, inlier line matches within 2 a frame.
(c) The port alone: BatchTracker over render_sequence(n=10, seed=s) for
    s in (0, 7): every state OK and ATE < 0.02 m per sequence
    (tests/test_multiseq.py::test_batch_tracker_matches_single's gate),
    and no kernel launched on the CPU.
(d) The full step (lines, planes, Manhattan axes; `config.full_step`) on
    the batch, port only: one batched step of 2 sequences against their
    S = 1 steps from carried states (after frames 0-1; poses within 1e-5,
    identical point, line and plane matches, measured axes within 1e-5);
    and, at 320x240, a batch of `tum3_config()` with local BA and a
    keyframe every frame, whose Manhattan frames are dropped after the
    initialization: the coarse Manhattan init runs only at the
    initialization (the JAX batch path never retries it before a keyframe,
    hfvo_tpu/parallel/multiseq.py:173-181), and local BA runs after each
    keyframe once the map has 4, leaving the pose on the newest
    keyframe's.
The JAX batch tracker runs once, in one module fixture.
"""
import dataclasses

import numpy as np
import pytest

from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.parallel.multiseq import BatchTracker as JaxBatchTracker
from hfvo_tpu_torch import convert
from hfvo_tpu_torch.config import full_step, points_and_lines, tum3_config
from hfvo_tpu_torch.io import evaluate
from hfvo_tpu_torch.parallel.multiseq import BatchTracker
from hfvo_tpu_torch.solve import lm as tlm
from hfvo_tpu_torch.testing import synthetic as tsyn
from hfvo_tpu_torch.tracking.tracker import Tracker, TrackState, _gray_u8, run_fused_step
from test_torch_pose_opt import TINTR, _line_scene, _twist_pose
from torch_helpers import half_camera, t

N_PARITY = 4


def _jax_cfg():
    c = jax_tum3()
    return c.replace(
        use_lines=True, use_planes=False, use_manhattan=False,
        tracking=dataclasses.replace(c.tracking, triangulate_new_points=False,
                                     triangulate_new_lines=False),
    )


def _port_cfg():
    return points_and_lines(tum3_config())


def _line_inliers(tracker) -> int:
    llo = tracker._last_line_out
    return 0 if llo is None else int((np.asarray(llo[2]) >= 0).sum())


def _pose_gap(Ta, Tb):
    D = Ta @ np.linalg.inv(Tb)
    rot = np.degrees(np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)))
    return np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]), rot


# ---- (a) one batched step against S single steps -------------------------


@pytest.fixture(scope="module")
def three_states():
    """Frames of three orbits and, for each, a tracker's state after its
    frames 0-2 (initialized at frame 0 with the ground-truth pose)."""
    seqs, states = [], []
    for seed in (0, 7, 3):
        T_wc, grays, depths = tsyn.render_sequence(n=4, seed=seed)
        tr = Tracker(_port_cfg(), "cpu", use_local_ba=False, use_loop_closing=False)
        for i in range(3):
            tr.track_rgbd(grays[i], depths[i], T_cw_init=np.linalg.inv(T_wc[0]))
        seqs.append((grays[3], depths[3]))
        states.append(convert.tracker_state_numpy(tr))
    return seqs, states


def _step(seqs, states, ids):
    """One fused step of the sequences `ids`, each from its stored state."""
    trs = []
    for k in ids:
        tr = Tracker(_port_cfg(), "cpu", use_local_ba=False, use_loop_closing=False)
        convert.tracker_state_from_numpy(tr, states[k])
        trs.append(tr)
    gray = t(np.stack([_gray_u8(seqs[k][0]) for k in ids]))
    depth = t(np.stack([tr._depth_host_u16(seqs[k][1]) for tr, k in zip(trs, ids)]).astype(np.int32))
    args = [tr.prepare_step(tr.velocity @ tr.T_cw) for tr in trs]
    return run_fused_step(_port_cfg(), gray, depth, args), args


def test_a_batched_step_equals_single_steps(three_states):
    seqs, states = three_states
    batched, args = _step(seqs, states, [0, 1, 2])
    assert len({len(a.pad) for a in args}) == 3  # snapshots of three lengths, padded
    for k in range(3):
        ((one, _),), _ = _step(seqs, states, [k])
        got = batched[k][0]
        np.testing.assert_allclose(got.T_cw, one.T_cw, atol=1e-5, rtol=0)
        assert got.n_inliers == one.n_inliers > 100
        for name in ("inlier", "pt_local", "visible", "words"):
            np.testing.assert_array_equal(getattr(got, name), getattr(one, name), err_msg=name)
        for name in ("ln_local", "ln_inlier", "visible", "rec_rows", "rec_inlier"):
            np.testing.assert_array_equal(getattr(got.lines, name), getattr(one.lines, name), err_msg=name)
        assert got.lines.ln_inlier.sum() > 0


@pytest.mark.parametrize("n_rounds,n_iters", [(1, 2), (1, 4), (4, 10)])
def test_a_batched_lm_visits_each_sequence_alone(n_rounds, n_iters):
    """Three scenes started from different poses with different point noise,
    as one (3, ...) batch and one by one: the same pose and inliers at each
    prefix of the visited sequence."""
    T0, X, obs, stereo, Xw, line2d, lvalid, dw, dc, dvalid = _line_scene()
    rng = np.random.default_rng(11)
    scenes = []
    for k, scale in enumerate((1.0, -0.5, 2.0)):
        obs_k = obs.copy()
        obs_k[:, :2] += rng.normal(size=(len(obs), 2)).astype(np.float32) * 0.3 * k
        T0_k = _twist_pose(np.array([0.01, 0.02, -0.01, 0.01, 0.02, -0.01]) * scale, T0)
        scenes.append((T0_k, obs_k))
    ones = lambda n: np.ones((n,), np.float32)  # noqa: E731

    def solve(T0s, obss):
        lead = T0s.shape[:-2]  # () alone, (3,) batched: every table gets it
        b = lambda a: t(np.broadcast_to(a, lead + np.shape(a)))  # noqa: E731
        pts = tlm.PoseObs(b(X), t(obss), b(stereo), b(ones(len(X))), b(np.ones(len(X), bool)))
        return tlm.pose_optimization(
            t(T0s), pts, TINTR,
            lines=tlm.LineObs(b(Xw), b(line2d), b(ones(len(Xw))), b(lvalid)),
            dirs=tlm.DirObs(b(dw), b(dc), b(ones(len(dw))), b(dvalid)),
            n_rounds=n_rounds, n_iters=n_iters,
        )

    batched = solve(np.stack([s[0] for s in scenes]), np.stack([s[1] for s in scenes]))
    for k, (T0_k, obs_k) in enumerate(scenes):
        one = solve(T0_k, obs_k)
        np.testing.assert_allclose(batched.T_cw[k].numpy(), one.T_cw.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(batched.inlier[k].numpy(), one.inlier.numpy())
        np.testing.assert_array_equal(batched.line_inlier[k].numpy(), one.line_inlier.numpy())
        assert int(batched.n_inliers[k]) == int(one.n_inliers)


# ---- (b) JAX BatchTracker against the port's ----------------------------


@pytest.fixture(scope="module")
def orbits():
    return [tsyn.render_sequence(n=2 + N_PARITY, seed=s) for s in (0, 7)]


def _batch_frames(orbits, i):
    return [o[1][i] for o in orbits], [o[2][i] for o in orbits]


def _run_parity(bt, orbits):
    """Frames 2 .. 2 + N_PARITY - 1 through a batch tracker (either
    package): poses, keyframe flags and inlier line matches, (frame, seq)."""
    poses, kfs, nl = [], [], []
    for i in range(2, 2 + N_PARITY):
        res = bt.track_batch(*_batch_frames(orbits, i))
        poses.append([r.T_cw for r in res])
        kfs.append([bool(r.is_keyframe) for r in res])
        nl.append([_line_inliers(tr) for tr in bt.trackers])
    return np.array(poses), kfs, nl


@pytest.fixture(scope="module")
def jax_batch_run(orbits):
    """hfvo_tpu's BatchTracker over frames 0-1 (initialized at frame 0),
    its tracker states as numpy then, and its parity frames."""
    bt = JaxBatchTracker(_jax_cfg(), n_seq=2, use_local_ba=False)
    inits = [np.linalg.inv(o[0][0]) for o in orbits]
    bt.track_batch(*_batch_frames(orbits, 0), inits)
    bt.track_batch(*_batch_frames(orbits, 1))
    states = [convert.tracker_state_numpy(tr) for tr in bt.trackers]
    return states, _run_parity(bt, orbits)


def test_b_batch_parity_with_jax(orbits, jax_batch_run):
    states, (j_poses, j_kfs, j_nl) = jax_batch_run
    bt = BatchTracker(_port_cfg(), n_seq=2, device="cpu", use_local_ba=False)
    convert.batch_tracker_state_from_numpy(bt, states)
    p_poses, p_kfs, p_nl = _run_parity(bt, orbits)
    assert p_kfs == j_kfs
    for i in range(N_PARITY):
        for s in range(2):
            dt, dr = _pose_gap(p_poses[i, s], j_poses[i, s])
            assert dt < 2e-3 and dr < 0.1, f"frame {i + 2} seq {s}: {dt * 1e3:.3f} mm, {dr:.4f} deg"
            assert abs(p_nl[i][s] - j_nl[i][s]) <= 2, f"frame {i + 2} seq {s}: {p_nl[i][s]} vs {j_nl[i][s]}"
    assert np.sum(j_nl) > 0


def test_batch_state_count_must_match(jax_batch_run):
    states, _ = jax_batch_run
    bt = BatchTracker(_port_cfg(), n_seq=3, device="cpu", use_local_ba=False)
    with pytest.raises(ValueError, match="3"):
        convert.batch_tracker_state_from_numpy(bt, states)


# ---- (c) the port alone ---------------------------------------------------


def test_c_port_batch_tracks_sequences():
    """Also: on the CPU the batch run launches no kernel."""
    from hfvo_tpu_torch.ops import fast, lines

    n = 10
    seqs = [tsyn.render_sequence(n=n, seed=s) for s in (0, 7)]
    bt = BatchTracker(_port_cfg(), n_seq=2, device="cpu", use_local_ba=False)
    bt.warmup()  # nothing to build on the CPU
    for i in range(n):
        inits = [np.linalg.inv(q[0][0]) for q in seqs] if i == 0 else None
        res = bt.track_batch([q[1][i] for q in seqs], [q[2][i] for q in seqs], inits)
        assert all(r.state is TrackState.OK for r in res), (i, [r.state for r in res])
    assert (fast.fast_dual_launches, fast.fast_dual_batched_launches,
            lines.hough_vote_launches, lines.hough_vote_batched_launches) == (0, 0, 0, 0)
    ts = np.arange(n) / 30.0
    for s, est in enumerate(bt.get_trajectories()):
        ape = evaluate.ate(ts, seqs[s][0], ts, est, align="origin")
        assert ape.rmse < 0.02, f"seq {s}: {ape.rmse}"


# ---- (d) the full step on the batch ---------------------------------------


def _full_cfg(base=None, **tracking):
    cfg = base or full_step(tum3_config())
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, **tracking))


def test_d_full_batched_step_equals_single_steps():
    seqs, states = [], []
    for seed in (0, 7):
        T_wc, grays, depths = tsyn.render_sequence(n=3, seed=seed)
        tr = Tracker(_full_cfg(), "cpu", use_local_ba=False, use_loop_closing=False)
        for i in range(2):
            tr.track_rgbd(grays[i], depths[i], T_cw_init=np.linalg.inv(T_wc[0]))
        assert tr.manh_valid
        seqs.append((grays[2], depths[2]))
        states.append(convert.tracker_state_numpy(tr))

    def step(ids):
        trs = []
        for k in ids:
            tr = Tracker(_full_cfg(), "cpu", use_local_ba=False, use_loop_closing=False)
            convert.tracker_state_from_numpy(tr, states[k])
            trs.append(tr)
        gray = t(np.stack([_gray_u8(seqs[k][0]) for k in ids]))
        depth = t(np.stack([tr._depth_host_u16(seqs[k][1]) for tr, k in zip(trs, ids)]).astype(np.int32))
        args = [tr.prepare_step(tr.velocity @ tr.T_cw) for tr in trs]
        return run_fused_step(_full_cfg(), gray, depth, args)

    batched = step([0, 1])
    for k in range(2):
        ((one, _),) = step([k])
        got = batched[k][0]
        np.testing.assert_allclose(got.T_cw, one.T_cw, atol=1e-5, rtol=0)
        assert got.n_inliers == one.n_inliers > 100
        for name in ("inlier", "pt_local", "visible"):
            np.testing.assert_array_equal(getattr(got, name), getattr(one, name), err_msg=name)
        for name in ("ln_local", "ln_inlier", "rec_rows", "rec_inlier"):
            np.testing.assert_array_equal(getattr(got.lines, name), getattr(one.lines, name), err_msg=name)
        for name in ("map_idx", "kind", "inlier"):
            np.testing.assert_array_equal(getattr(got.planes, name), getattr(one.planes, name), err_msg=name)
        np.testing.assert_array_equal(got.planes.seg.valid, one.planes.seg.valid)
        assert ((got.planes.kind == 0) & got.planes.inlier).sum() >= 1
        np.testing.assert_allclose(got.manh[0], one.manh[0], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got.manh[1], one.manh[1])


def test_d_full_batch_coarse_init_at_init_only_and_local_ba(monkeypatch):
    n = 4
    seqs = [tsyn.render_sequence(n=n, intr=half_camera(), seed=s) for s in (0, 7)]
    calls = []
    coarse = Tracker._try_coarse_manhattan
    monkeypatch.setattr(Tracker, "_try_coarse_manhattan",
                        lambda self, depth: (calls.append(self.frame_id), coarse(self, depth))[1])
    # tum3_config() itself (triangulation on, which the batch path never runs).
    cfg = _full_cfg(tum3_config(), max_frames_between_kf=1).replace(camera=half_camera())
    bt = BatchTracker(cfg, n_seq=2, device="cpu", use_local_ba=True)
    kfs = []
    for i in range(n):
        inits = [np.linalg.inv(q[0][0]) for q in seqs] if i == 0 else None
        res = bt.track_batch([q[1][i] for q in seqs], [q[2][i] for q in seqs], inits)
        assert all(r.state is TrackState.OK for r in res), (i, [r.state for r in res])
        kfs.append([bool(r.is_keyframe) for r in res])
        if i == 0:
            assert calls == [0, 0] and all(tr.manh_valid for tr in bt.trackers)
            for tr in bt.trackers:  # a single Tracker would now retry before each keyframe
                tr.manh_valid = tr.mapper.manh_valid = False
                tr.mapper.R_wm = None
        for tr, r in zip(bt.trackers, res):
            np.testing.assert_array_equal(r.T_cw, tr.vomap.keyframes.T_cw[tr.vomap.newest_kf_slot])
    assert calls == [0, 0]
    assert all(all(k) for k in kfs)  # every frame a keyframe
    for tr in bt.trackers:
        assert tr.vomap.n_keyframes() == n
        assert tr.mapper.n_ba_runs == n - 3  # from the 4th keyframe on
        assert tr.stage_times["local_ba"][1] == n - 1  # timed at every tracked keyframe, as in the JAX package
