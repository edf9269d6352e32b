"""A run with the timed path broken underneath comes out not correct.

Each test drives run.run_cell on the CPU (it skips only the look for a
card) from a copy of the benchmark whose set-up is cut for the CPU (a short
rendered prefix, no keyframe-path warm-up), once per fault that a cell can
have: a step that returns its state unchanged (the tracker's, and a local
BA solve's), half of the batch left out, an answer altered where it is
produced (a FAST score in the kernel's output, a pose in the facade's, the
BA's inlier flags and cost). No cell spans chips, so no exchange between
chips can be left out."""
import json
import math
import shutil

import numpy as np
import pytest
import torch

from hfvo_bench import run

from .conftest import ROOT


@pytest.fixture(scope="module")
def cpu_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "hfvo_bench", root / "hfvo_bench")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    p = root / "hfvo_bench" / "traffic" / "orbit_textured.json"
    t = json.loads(p.read_text())
    t["warmup_frames"] = 2
    t["samples"].update(kernel_frames=1, kernel_frame_pool=1, ba_run_pool=1)
    p.write_text(json.dumps(t))
    for c in ("tum3_vo", "tum3_batch8"):
        p = root / "hfvo_bench" / "configs" / f"{c}.json"
        d = json.loads(p.read_text())
        d["warmup"]["keyframe_path_max_frames"] = 1
        p.write_text(json.dumps(d))
    return root


@pytest.fixture(scope="module")
def kf_root(cpu_root, tmp_path_factory):
    """The CPU copy with `vo_orbit` on the low-texture mix, which makes a
    keyframe, and so runs local BA, on most frames: a short window on a
    slow CPU still holds a BA run for the BA faults."""
    root = tmp_path_factory.mktemp("bench_kf")
    shutil.copytree(cpu_root / "hfvo_bench", root / "hfvo_bench")
    spec = json.loads((cpu_root / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        if w["name"] == "vo_orbit":
            w["traffic"] = "orbit_low_texture"
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    p = root / "hfvo_bench" / "traffic" / "orbit_low_texture.json"
    t = json.loads(p.read_text())
    t["warmup_frames"] = 2
    t["samples"].update(kernel_frames=1, kernel_frame_pool=1, ba_run_pool=1)
    p.write_text(json.dumps(t))
    return root


def _fails(r, name):
    c = r["checks"][name]
    return c["value"] is not None and float(c["value"]) > c["limit"]


def _pose_fails(r):
    return _fails(r, "pose_ate_m")


def _run(root, cell, seconds):
    torch.set_num_threads(4)
    args = run.parse(["--workload", cell, "--seed", "2147483701", "--seconds", str(seconds)])
    result, compared, _ = run.run_cell(args, root=root, device="cpu")
    print(cell, json.dumps(result["checks"]))
    return result


def test_sound_run_is_correct(cpu_root):
    r = _run(cpu_root, "vo_orbit", 10)
    assert r["correct"], json.dumps(r["checks"])
    assert r["checks"]["pose_ate_m"]["value"] is not None


def test_state_left_unchanged(cpu_root, monkeypatch):
    from hfvo_tpu_torch.tracking.tracker import Tracker

    orig = Tracker._post_track

    def frozen(self, five, gray, depth):
        T = self.T_cw.copy()
        res = orig(self, five, gray, depth)
        self.T_cw = T
        res.T_cw = T.copy()
        return res

    monkeypatch.setattr(Tracker, "_post_track", frozen)
    r = _run(cpu_root, "vo_orbit", 30)
    assert not r["correct"] and _pose_fails(r), r["checks"]


def test_fast_score_altered(cpu_root, monkeypatch):
    from hfvo_tpu_torch.ops import fast

    orig = fast.fast_score_dual_reference

    def altered(img, lo, hi, bonus=1e4):
        out = orig(img, lo, hi, bonus)
        out.view(-1)[out.numel() // 2] += 1.0
        return out

    monkeypatch.setattr(fast, "fast_score_dual_reference", altered)
    r = _run(cpu_root, "vo_orbit", 4)
    assert not r["correct"]
    assert r["checks"]["fast_max_abs_err"]["value"] > 0


def test_pose_altered(cpu_root, monkeypatch):
    from hfvo_tpu_torch.system import VOSystem

    orig = VOSystem.track_rgbd
    calls = []

    def altered(self, gray, depth, ts):
        res = orig(self, gray, depth, ts)
        calls.append(1)
        if len(calls) == 5:
            res.T_cw = res.T_cw.copy()
            res.T_cw[0, 3] += 1.0
            c, s = math.cos(0.5), math.sin(0.5)  # and turned by 0.5 rad about z
            res.T_cw[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32) @ res.T_cw[:3, :3]
        return res

    monkeypatch.setattr(VOSystem, "track_rgbd", altered)
    r = _run(cpu_root, "vo_orbit", 20)
    assert not r["correct"] and _pose_fails(r) and _fails(r, "pose_rot_max_deg"), r["checks"]


def test_ba_returns_its_input(kf_root, monkeypatch):
    """Local BA's Levenberg-Marquardt steps are all zero: the solve returns
    the state it was given, with that state's gate and cost."""
    from hfvo_tpu_torch.solve import ba

    monkeypatch.setattr(ba, "_schur_solve", lambda prob, Hpp, Hll, *a: (torch.zeros_like(Hpp[:, :, 0]),
                                                                     torch.zeros_like(Hll[:, :, 0])))
    r = _run(kf_root, "vo_orbit", 20)
    assert r["samples"]["ba_checked"], r["samples"]
    assert not r["correct"] and _fails(r, "ba_point_step_gain"), r["checks"]


def test_ba_flags_every_edge_an_outlier(kf_root, monkeypatch):
    """The solve's answer altered where it is produced: every edge flagged
    an outlier, the cost reported 0."""
    from hfvo_tpu_torch.solve import ba

    orig = ba.final_gate

    def none_in(prob, kf_T, pt_X, *a, **k):
        res = orig(prob, kf_T, pt_X, *a, **k)
        return res._replace(e_inlier=torch.zeros_like(res.e_inlier), le_inlier=torch.zeros_like(res.le_inlier),
                            chi2=torch.zeros_like(res.chi2))

    monkeypatch.setattr(ba, "final_gate", none_in)
    r = _run(kf_root, "vo_orbit", 20)
    assert r["samples"]["ba_checked"], r["samples"]
    assert not r["correct"] and _fails(r, "ba_chi2_rel_err") and _fails(r, "ba_flags_wrong"), r["checks"]


def test_half_the_batch_left_out(cpu_root, monkeypatch):
    """The second half of every resolved batch never comes back."""
    from hfvo_tpu_torch.parallel.multiseq import BatchTracker

    def halved(fn):
        def wrapped(self, *a):
            out = fn(self, *a)
            n = self.n_seq
            return [r for k, r in enumerate(out) if k % n < n // 2]
        return wrapped

    monkeypatch.setattr(BatchTracker, "track_batch_async", halved(BatchTracker.track_batch_async))
    monkeypatch.setattr(BatchTracker, "flush", halved(BatchTracker.flush))
    r = _run(cpu_root, "batch8_orbit", 20)
    assert not r["correct"], json.dumps(r["checks"])
    assert r["checks"]["frames_unmatched"]["value"] > 0
