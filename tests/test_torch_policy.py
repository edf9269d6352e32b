"""Port policy: fp32 everywhere, no JAX import, shared constant tables,
entry points on the card unless the CPU is asked for, and
NotImplementedError for everything outside the points-only, points + lines,
full-step and batch slices (the batch path still refuses planes and
Manhattan axes)."""
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
from hfvo_tpu_torch.config import points_and_lines, points_only, tum3_config
from hfvo_tpu_torch.ops import fast
from hfvo_tpu_torch.parallel.multiseq import BatchTracker
from hfvo_tpu_torch.system import VOSystem
from hfvo_tpu_torch.tracking.tracker import Tracker, TrackState

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


_OUT_OF_SLICE = {
    "use_lines": lambda: (
        points_and_lines(tum3_config()).replace(tracking=dataclasses.replace(
            tum3_config().tracking, triangulate_new_points=False, triangulate_new_lines=True)),
        {},
    ),
    # Tracker and VOSystem run planes and Manhattan axes; the batch path
    # does not yet.
    "use_planes": lambda: (points_only(tum3_config()).replace(use_planes=True), {"batch": True}),
    "use_manhattan": lambda: (points_only(tum3_config()).replace(use_manhattan=True), {"batch": True}),
    "use_local_ba": lambda: (points_only(tum3_config()), {"use_local_ba": True}),
    "use_loop_closing": lambda: (points_only(tum3_config()), {"use_loop_closing": True}),
    "triangulate_new_points": lambda: (_with_tracking(triangulate_new_points=True), {}),
    "triangulate_new_lines": lambda: (_with_tracking(triangulate_new_lines=True), {}),
    "inv_sigma2_3d": lambda: (_with_tracking(inv_sigma2_3d=400.0), {}),
    "static_mask_path": lambda: (_with_tracking(static_mask_path="mask.png"), {}),
}


@pytest.mark.parametrize("option", sorted(_OUT_OF_SLICE))
def test_out_of_slice_raises(option):
    cfg, kw = _OUT_OF_SLICE[option]()
    if kw.pop("batch", False):
        with pytest.raises(NotImplementedError, match="slice"):
            BatchTracker(cfg, n_seq=2, device="cpu", use_local_ba=False)
        return
    kw = {"use_local_ba": False, "use_loop_closing": False, **kw}
    with pytest.raises(NotImplementedError, match="slice"):
        Tracker(cfg, "cpu", **kw)


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


def test_default_config_is_out_of_slice():
    """The default (hybrid) config is refused, not silently downgraded."""
    with pytest.raises(NotImplementedError):
        VOSystem(tum3_config(), "cpu")


def test_fast_wrapper_refuses_other_devices():
    img = torch.zeros((16, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fast.fast_score_dual(img, 7.0, 20.0)


_ENTRY_POINTS = {
    "VOSystem": lambda cfg, **kw: VOSystem(cfg, use_local_ba=False, use_loop_closing=False, **kw),
    "Tracker": lambda cfg, **kw: Tracker(cfg, use_local_ba=False, use_loop_closing=False, **kw),
    "BatchTracker": lambda cfg, **kw: BatchTracker(cfg, n_seq=2, use_local_ba=False, **kw),
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
    "use_local_ba": ({"use_local_ba": True}, "keyframe-path"),
    "pipeline_depth": ({"pipeline_depth": 2}, "facade"),
}


@pytest.mark.parametrize("option", sorted(_BATCH_REFUSALS))
def test_batch_options_out_of_slice_raise(option):
    kw, where = _BATCH_REFUSALS[option]
    kw = {"use_local_ba": False, **kw}
    with pytest.raises(NotImplementedError, match=where):
        BatchTracker(points_and_lines(tum3_config()), n_seq=2, device="cpu", **kw)


def test_batch_async_and_lost_out_of_slice_raise():
    bt = BatchTracker(points_only(tum3_config()), n_seq=2, device="cpu", use_local_ba=False)
    frames = [np.zeros((48, 64), np.float32)] * 2
    with pytest.raises(NotImplementedError, match="facade"):
        bt.track_batch_async(frames, frames)
    with pytest.raises(NotImplementedError, match="facade"):
        bt.flush()
    bt.trackers[1].state = TrackState.LOST
    with pytest.raises(NotImplementedError, match="relocalization"):
        bt.track_batch(frames, frames)
    assert [tr.frame_id for tr in bt.trackers] == [-1, -1]  # refused before any work
