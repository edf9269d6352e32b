"""Port policy: fp32 everywhere, no JAX import, shared constant tables,
entry points on the card unless the CPU is asked for, and
NotImplementedError for what is not ported yet (the static mask, the
facade's options, the async paths, the distributed solvers). Options that
earlier slices refused and that now run (the triangulations, local BA,
the full step on the batch, loop closing, the metric 3D term, the default
system, a LOST sequence in the batch) keep their cases, which now
construct the entry point and track two frames with it (at 320x240, to
keep them quick)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import hfvo_tpu_torch  # noqa: F401  (sets the fp32 policy)
from hfvo_tpu.bow import vocab as jax_vocab
from hfvo_tpu.ops import orb as jax_orb
from hfvo_tpu_torch import convert
from hfvo_tpu_torch.bow.database import KeyFrameDatabase
from hfvo_tpu_torch.config import Capacities, points_and_lines, points_only, tum3_config
from hfvo_tpu_torch.mapping.loop_closing import LoopCloser
from hfvo_tpu_torch.ops import fast
from hfvo_tpu_torch.parallel.multiseq import BatchTracker
from hfvo_tpu_torch.solve.global_ba import run_global_ba
from hfvo_tpu_torch.system import VOSystem
from hfvo_tpu_torch.testing import loop_map
from hfvo_tpu_torch.testing import synthetic as tsyn
from hfvo_tpu_torch.tracking.tracker import Tracker, TrackState
from hfvo_tpu_torch.vomap.map import VOMap
from torch_helpers import half_camera

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fp32_policy_flags():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_import_without_jax():
    """Every module of the port imports with `jax` and `hfvo_tpu` blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['hfvo_tpu'] = None\n"
        "import hfvo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(hfvo_tpu_torch.__path__, 'hfvo_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) > 20, names\n"
        "assert 'hfvo_tpu_torch.parallel.multiseq' in names, names\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_constant_tables_match_jax():
    convert.constants_from_numpy(
        jax_orb.BRIEF_PATTERN, jax_orb.BIN_DIFF_MATS, jax_vocab.PROTOTYPES
    )


def test_constant_tables_mismatch_raises():
    bad = np.array(jax_vocab.PROTOTYPES)
    bad[3, 7] *= -1
    with pytest.raises(ValueError, match="PROTOTYPES"):
        convert.constants_from_numpy(jax_orb.BRIEF_PATTERN, jax_orb.BIN_DIFF_MATS, bad)


def _with_tracking(**kw):
    cfg = points_only(tum3_config())
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, **kw))


@pytest.fixture(scope="module")
def two_frames():
    return tsyn.render_sequence(n=2, intr=half_camera(), seed=0)


def _tracks_two_frames(make, cfg, frames, batch: bool) -> None:
    """Construct with `make(cfg)` at half size and track two frames: both
    OK."""
    T_wc, grays, depths = frames
    init = np.linalg.inv(T_wc[0])
    entry = make(cfg.replace(camera=half_camera()))
    for i in range(2):
        if batch:
            res = entry.track_batch([grays[i]] * 2, [depths[i]] * 2, [init] * 2 if i == 0 else None)
        else:
            res = [entry.track_rgbd(grays[i], depths[i], T_cw_init=init)]
        assert all(r.state is TrackState.OK for r in res), [r.state for r in res]


# Option -> (config, keyword arguments, "raises" or "runs"). "batch": the
# case is about BatchTracker.
_OUT_OF_SLICE = {
    # With the keyframe path ported, line triangulation runs.
    "use_lines": lambda: (
        points_and_lines(tum3_config()).replace(tracking=dataclasses.replace(
            tum3_config().tracking, triangulate_new_points=False, triangulate_new_lines=True)),
        {}, "runs",
    ),
    # The batch path runs the full step (planes and Manhattan axes).
    "use_planes": lambda: (points_only(tum3_config()).replace(use_planes=True), {"batch": True}, "runs"),
    "use_manhattan": lambda: (points_only(tum3_config()).replace(use_manhattan=True), {"batch": True}, "runs"),
    "use_local_ba": lambda: (points_only(tum3_config()), {"use_local_ba": True}, "runs"),
    # Relocalization and loop closing are ported: the closer runs at each keyframe.
    "use_loop_closing": lambda: (points_only(tum3_config()), {"use_loop_closing": True}, "runs"),
    "triangulate_new_points": lambda: (_with_tracking(triangulate_new_points=True), {}, "runs"),
    "triangulate_new_lines": lambda: (_with_tracking(triangulate_new_lines=True), {}, "runs"),
    "inv_sigma2_3d": lambda: (_with_tracking(inv_sigma2_3d=400.0), {}, "runs"),
    "static_mask_path": lambda: (_with_tracking(static_mask_path="mask.png"), {}, "raises"),
}


@pytest.mark.parametrize("option", sorted(_OUT_OF_SLICE))
def test_out_of_slice_raises(option, two_frames):
    cfg, kw, expect = _OUT_OF_SLICE[option]()
    batch = kw.pop("batch", False)
    if batch:
        def make(cfg):
            return BatchTracker(cfg, n_seq=2, device="cpu", use_local_ba=False)
    else:
        kw = {"use_local_ba": False, "use_loop_closing": False, **kw}

        def make(cfg):
            return Tracker(cfg, "cpu", **kw)
    if expect == "raises":
        with pytest.raises(NotImplementedError, match="slice"):
            make(cfg)
        return
    _tracks_two_frames(make, cfg, two_frames, batch=batch)


@pytest.mark.parametrize("make", [points_only, points_and_lines])
def test_slice_configs_construct(make):
    system = VOSystem(make(tum3_config()), "cpu", use_local_ba=False, use_loop_closing=False)
    cfg = system.cfg
    assert cfg.use_lines == (make is points_and_lines)
    assert not (cfg.use_planes or cfg.use_manhattan)
    assert not (cfg.tracking.triangulate_new_points or cfg.tracking.triangulate_new_lines)
    assert cfg.lines.lk_recovery and (cfg.cap.lines, cfg.cap.local_lines, cfg.cap.map_lines) == (256, 1024, 4096)


@pytest.mark.parametrize("option", ["settings_yaml", "vocabulary_path", "use_viewer"])
def test_facade_options_out_of_slice_raise(option):
    value = True if option == "use_viewer" else "x"
    with pytest.raises(NotImplementedError, match="facade"):
        VOSystem(points_only(tum3_config()), "cpu", use_local_ba=False,
                 use_loop_closing=False, **{option: value})


def test_async_tracking_out_of_slice_raises():
    tracker = Tracker(points_only(tum3_config()), "cpu", use_local_ba=False,
                      use_loop_closing=False)
    with pytest.raises(NotImplementedError, match="facade"):
        tracker.track_rgbd_async(np.zeros((48, 64), np.float32), np.zeros((48, 64), np.float32))


def test_default_config_is_out_of_slice(two_frames):
    """The default system, every default on (local BA, loop closing, the
    early-loss reset), constructs and tracks two frames (the case once
    asserted its refusal)."""
    system = VOSystem(tum3_config(), "cpu")
    tr = system.tracker
    assert tr.use_local_ba and tr.use_loop_closing and tr.auto_reset and tr.loop_closer is not None
    assert system.cfg.tracking.triangulate_new_points and system.cfg.tracking.triangulate_new_lines
    _tracks_two_frames(lambda cfg: Tracker(cfg, "cpu"), tum3_config(), two_frames, batch=False)


def test_fast_wrapper_refuses_other_devices():
    img = torch.zeros((16, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fast.fast_score_dual(img, 7.0, 20.0)


def _global_ba_on_loop_map(cfg, **kw):
    """One LM iteration of the whole-map BA on the synthetic loop map."""
    cfg = cfg.replace(cap=Capacities(map_points=2048, map_lines=256, map_planes=16, keyframes=32))
    vm = VOMap(cfg)
    loop_map.build_loop_map(vm, KeyFrameDatabase(cfg.cap.keyframes), cfg)
    return run_global_ba(vm, cfg.camera, n_iters=1, **kw)


_ENTRY_POINTS = {
    "VOSystem": lambda cfg, **kw: VOSystem(cfg, use_local_ba=False, use_loop_closing=False, **kw),
    "Tracker": lambda cfg, **kw: Tracker(cfg, use_local_ba=False, use_loop_closing=False, **kw),
    "BatchTracker": lambda cfg, **kw: BatchTracker(cfg, n_seq=2, use_local_ba=False, **kw),
    # The loop closer and the global BA a caller may drive on a map of its own.
    "LoopCloser": lambda cfg, **kw: LoopCloser(cfg, VOMap(cfg), **kw),
    "run_global_ba": _global_ba_on_loop_map,
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without a card the default device raises; nothing falls back to the
    CPU. Asking for the CPU works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = _ENTRY_POINTS[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(points_and_lines(tum3_config()))
    make(points_and_lines(tum3_config()), device="cpu")


_BATCH_REFUSALS = {
    "mesh": ({"mesh": object()}, "distributed"),
    # Local BA after a batch keyframe is ported: it constructs and steps.
    "use_local_ba": ({"use_local_ba": True}, None),
    "pipeline_depth": ({"pipeline_depth": 2}, "facade"),
}


@pytest.mark.parametrize("option", sorted(_BATCH_REFUSALS))
def test_batch_options_out_of_slice_raise(option, two_frames):
    kw, where = _BATCH_REFUSALS[option]
    kw = {"use_local_ba": False, **kw}

    def make(cfg):
        return BatchTracker(cfg, n_seq=2, device="cpu", **kw)
    cfg = points_and_lines(tum3_config())
    if where is None:
        _tracks_two_frames(make, cfg, two_frames, batch=True)
        assert all(tr.use_local_ba for tr in make(cfg).trackers)
        return
    with pytest.raises(NotImplementedError, match=where):
        make(cfg)


def test_distributed_local_ba_out_of_slice_raises():
    from hfvo_tpu_torch.mapping.local_mapping import LocalMapper
    from hfvo_tpu_torch.vomap.map import VOMap

    cfg = tum3_config()
    mapper = LocalMapper(cfg, VOMap(cfg), "cpu", use_distributed=True)
    with pytest.raises(NotImplementedError, match="distributed"):
        mapper.run_local_ba()


def test_batch_async_and_lost_out_of_slice_raise(two_frames):
    """The async batch entry points are refused; a LOST sequence (once
    refused) is stepped inside the batch from its motion model, with no
    relocalization, as the JAX package's batch steps it."""
    bt = BatchTracker(points_only(tum3_config()), n_seq=2, device="cpu", use_local_ba=False)
    frames = [np.zeros((48, 64), np.float32)] * 2
    with pytest.raises(NotImplementedError, match="facade"):
        bt.track_batch_async(frames, frames)
    with pytest.raises(NotImplementedError, match="facade"):
        bt.flush()
    assert [tr.frame_id for tr in bt.trackers] == [-1, -1]  # refused before any work
    bt = BatchTracker(points_only(tum3_config()).replace(camera=half_camera()), n_seq=2, device="cpu",
                      use_local_ba=False)
    T_wc, grays, depths = two_frames
    bt.track_batch([grays[0]] * 2, [depths[0]] * 2, [np.linalg.inv(T_wc[0])] * 2)
    bt.trackers[1].state = TrackState.LOST
    res = bt.track_batch([grays[1]] * 2, [depths[1]] * 2)
    assert [tr.frame_id for tr in bt.trackers] == [1, 1]
    assert [r.state for r in res] == [TrackState.OK, TrackState.OK]
    assert "relocalize" not in bt.trackers[1].stage_times
