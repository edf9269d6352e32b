"""Manhattan axes and vanishing points: hfvo_tpu's mean-shift axis tracking,
coarse and fine Manhattan inits, line-axis assignment, plane seed pair and
vanishing points against the port's, on the same seeded numpy inputs.

Tolerances:
- measure_axes / refine_axes / support_rate: axes within 1e-6, identical
  support counts and rates.
- coarse_manhattan_init: the same support rate, and the same Manhattan
  frame modulo the 24 proper signed axis permutations within 1e-5 (many
  hypotheses converge to one frame with equal rates, and the first of them
  wins; which one is first may differ on a flipped borderline count).
- multiview_manh_init: the rotation within 1e-5, its cost within 1e-5
  relative.
- estimate_vps: VPs within 1e-5, identical supports, assignments and flag.
- line_axis_assignment, plane_seed_pair, the fixed hypotheses: equal.
- S = 2 against two S = 1 calls of the port: within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfvo_tpu.bow import vocab as jvocab
from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.ops import lines as jlines
from hfvo_tpu.ops import manhattan as jm
from hfvo_tpu.ops import orb as jorb
from hfvo_tpu.ops import planes as jp
from hfvo_tpu.ops import vp as jvp
from hfvo_tpu_torch import convert
from hfvo_tpu_torch.config import full_step, tum3_config
from hfvo_tpu_torch.geometry import se3 as tse3
from hfvo_tpu_torch.ops import manhattan as tm
from hfvo_tpu_torch.ops import vp as tvp
from hfvo_tpu_torch.testing import synthetic
from hfvo_tpu_torch.tracking import tracker as ttracker
from torch_helpers import same_frame, t

JCAM = jax_tum3().camera
TCAM = tum3_config().camera
def _rot(v) -> np.ndarray:
    return tse3.exp_so3(torch.tensor(v, dtype=torch.float32)).numpy()


@pytest.fixture(scope="module")
def scene():
    """Frame 5 of the orbit (gray, depth, its stride-8 normals and validity
    weights) and a rotation 3 deg off the room's axes seen from there."""
    T_wc = synthetic.orbit_trajectory(6)[5]
    gray, depth = (a.numpy() for a in synthetic.render(synthetic.make_room(0), TCAM, t(T_wc)))
    n, ok = jp.compute_normals(jnp.asarray(depth), JCAM, stride=8)
    R_cm = T_wc[:3, :3].T @ _rot([0.03, -0.04, 0.02])
    return gray, depth, np.asarray(n), np.asarray(ok).astype(np.float32), R_cm.astype(np.float32)


@pytest.mark.parametrize("fn", ["measure_axes", "refine_axes"])
def test_mean_shift_matches_jax(scene, fn):
    _, _, n, w, R = scene
    want = getattr(jm, fn)(jnp.asarray(R), jnp.asarray(n), jnp.asarray(w))
    got = getattr(tm, fn)(t(R), t(n), t(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].max() > 1000
    # A batch of 2 rotations against two single calls.
    R2 = np.stack([R, _rot([0.1, 0.2, -0.1]) @ R])
    both = getattr(tm, fn)(t(R2), t(np.stack([n, n])), t(np.stack([w, w])))
    for s in range(2):
        one = getattr(tm, fn)(t(R2[s]), t(n), t(w))
        np.testing.assert_allclose(both[0][s].numpy(), one[0].numpy(), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(both[1][s].numpy(), one[1].numpy())


def test_support_rate_matches_jax(scene):
    _, _, n, w, R = scene
    for Rq in (R, _rot([0.3, 0.0, 0.2]) @ R):
        want = float(jm.support_rate(jnp.asarray(Rq), jnp.asarray(n), jnp.asarray(w)))
        assert float(tm.support_rate(t(Rq), t(n), t(w))) == want


def test_fixed_hypotheses_match_jax():
    np.testing.assert_allclose(tm._FIXED_HYPS, jm._FIXED_HYPS, atol=1e-6, rtol=0)
    assert tm._FIXED_HYPS.shape == (40, 3, 3) and tm._FIXED_HYPS.dtype == np.float32
    # They are bit-equal, so they travel with the other constant tables.
    convert.constants_from_numpy(jorb.BRIEF_PATTERN, jorb.BIN_DIFF_MATS, jvocab.PROTOTYPES,
                                 manhattan_hyps=jm._FIXED_HYPS)


def _coarse_inputs(normals, ok, frame_id):
    """The coarse init's inputs as the tracker builds them
    (hfvo_tpu/tracking/tracker.py:1876-1891)."""
    d = normals[ok > 0]
    sub = d[:: max(len(d) // 1500, 1)].astype(np.float32)
    CAP = 1536
    n = min(len(sub), CAP)
    w = np.zeros((CAP,), np.float32)
    w[:n] = 1.0
    buf = np.zeros((CAP, 3), np.float32)
    buf[:n] = sub[:CAP]
    rng = np.random.RandomState(frame_id + 1)
    return buf, w, buf[rng.randint(0, max(n, 1), size=(24, 2))]


@pytest.mark.parametrize("frame_id", [0, 7])
def test_coarse_manhattan_init_matches_jax(scene, frame_id):
    _, _, n, w, _ = scene
    buf, wt, pairs = _coarse_inputs(n, w, frame_id)
    R_j, rate_j = jm.coarse_manhattan_init(jnp.asarray(buf), jnp.asarray(wt), jnp.asarray(pairs))
    R_t, rate_t = tm.coarse_manhattan_init(t(buf), t(wt), t(pairs))
    assert float(rate_t) == float(rate_j) > 0.95
    assert same_frame(R_t.numpy(), np.asarray(R_j), 1e-5)


def test_multiview_manh_init_matches_jax():
    """200 map-line directions along a frame 3 deg off the identity, with
    1.7 deg of noise, 20 % unassigned and 10 % assigned to a wrong axis."""
    rng = np.random.default_rng(4)
    L = 200
    axes = _rot([0.03, -0.02, 0.04])
    aidx = rng.integers(0, 3, L).astype(np.int32)
    d = axes.T[aidx] + rng.normal(size=(L, 3)) * 0.03
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    aidx[rng.random(L) < 0.2] = -1
    wrong = rng.random(L) < 0.1
    aidx[wrong] = (aidx[wrong] + 1) % 3
    wt = np.minimum(rng.integers(1, 12, L), 8).astype(np.float32)
    wt[:10] = 0.0
    d, R0 = d.astype(np.float32), np.eye(3, dtype=np.float32)
    R_j, c_j = jm.multiview_manh_init(jnp.asarray(R0), jnp.asarray(d), jnp.asarray(wt), jnp.asarray(aidx))
    R_t, c_t = tm.multiview_manh_init(t(R0), t(d), t(wt), t(aidx))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-5)
    assert np.abs(R_t.numpy() - axes).max() < 0.01  # it finds the frame


def test_line_axis_assignment_matches_jax(scene):
    _, _, _, _, R = scene
    rng = np.random.default_rng(2)
    d = np.concatenate([R.T[rng.integers(0, 3, 60)] + rng.normal(size=(60, 3)) * 0.05,
                        rng.normal(size=(40, 3))]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = np.asarray(jm.line_axis_assignment(jnp.asarray(R), jnp.asarray(d), cone=0.1018))
    got = tm.line_axis_assignment(t(R), t(d), cone=0.1018).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).sum() >= 30 and (want < 0).sum() >= 30
    R2 = np.stack([R, np.eye(3, dtype=np.float32)])
    both = tm.line_axis_assignment(t(R2), t(np.stack([d, d])), cone=0.1018).numpy()
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_array_equal(both[1], tm.line_axis_assignment(t(R2[1]), t(d), cone=0.1018).numpy())


@pytest.mark.parametrize("case", ["plane_pair", "plane_and_line", "none", "one_plane_no_line"])
def test_plane_seed_pair_matches_jax(case):
    rng = np.random.default_rng(9)
    n = rng.normal(size=(6, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[1] = np.cross(n[0], n[2]) / np.linalg.norm(np.cross(n[0], n[2]))
    n[3] = np.cross(n[0], n[1])
    counts = rng.uniform(100, 1000, 6).astype(np.float32)
    valid = np.array([True, True, False, True, True, False])
    lines = rng.normal(size=(20, 3)).astype(np.float32)
    lines[7] = np.cross(n[0], rng.normal(size=3))
    if case == "plane_and_line":
        valid = np.array([True, False, False, False, False, False])
    if case == "none":
        valid[:] = False
    if case == "one_plane_no_line":
        valid = np.array([False, False, False, False, True, False])
        lines = lines[:3] * 0 + n[4]
    want = jm.plane_seed_pair(n, counts, valid, line_dirs=lines, ver_th=0.08716)
    got = tm.plane_seed_pair(n, counts, valid, line_dirs=lines, ver_th=0.08716)
    if want is None:
        assert got is None and case in ("none", "one_plane_no_line")
        return
    np.testing.assert_array_equal(got, want)


def test_estimate_vps_matches_jax(scene):
    gray = scene[0]
    lf = [np.asarray(a) for a in jlines.detect_lines(jnp.asarray(gray), capacity=256)]
    p0, p1, valid = lf[0], lf[1], lf[5]
    want = jvp.estimate_vps(JCAM, jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid))
    got = tvp.estimate_vps(TCAM, t(p0), t(p1), t(valid))
    np.testing.assert_allclose(got.vps.numpy(), np.asarray(want.vps), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.support.numpy(), np.asarray(want.support))
    np.testing.assert_array_equal(got.line_vp.numpy(), np.asarray(want.line_vp))
    assert bool(got.ok) == bool(want.ok) is True
    np.testing.assert_allclose(tvp.line_normals(TCAM, t(p0), t(p1)).numpy(),
                               np.asarray(jvp.line_normals(JCAM, jnp.asarray(p0), jnp.asarray(p1))),
                               atol=1e-6, rtol=0)


def test_manhattan_prior_batch_equals_single(scene):
    """The fused step's Manhattan block at S = 2 (one sequence with a valid
    frame, one without) against two S = 1 calls."""
    _, depth, _, _, R = scene
    cfg = full_step(tum3_config())
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = _rot([0.01, 0.0, -0.01])
    R_wm = np.stack([T[:3, :3].T @ R, np.eye(3, dtype=np.float32)])
    valid = np.array([True, False])
    d2 = t(np.stack([depth, depth]))
    both = ttracker._manhattan_prior(cfg, d2, t(np.stack([T, T])), t(R_wm), t(valid))
    for s in range(2):
        one = ttracker._manhattan_prior(cfg, d2[s:s + 1], t(T[None]), t(R_wm[s:s + 1]), t(valid[s:s + 1]))
        for a, b in zip(both, one):
            np.testing.assert_allclose(a[s].numpy(), b[0].numpy(), atol=1e-6, rtol=0)
    assert (both[4][0] > 0).any() and not (both[4][1] > 0).any()  # anchors only with a frame
