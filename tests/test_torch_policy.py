"""Port policy: fp32 everywhere, no JAX import, shared constant tables,
and entry points on the card unless the CPU is asked for. Options that
earlier slices refused and that now run (the triangulations, local BA, the
full step on the batch, loop closing, the metric 3D term, the default
system, a LOST sequence in the batch, the static mask, the facade's
options, the async paths, the batch's mesh and the distributed local BA)
keep their cases, which now construct the entry point and track two frames
with it (at 320x240, to keep them quick) or call it."""
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
from hfvo_tpu_torch.bow.sharded_db import ShardedKeyFrameDatabase
from hfvo_tpu_torch.config import Capacities, points_and_lines, points_only, tum3_config
from hfvo_tpu_torch.mapping.loop_closing import LoopCloser
from hfvo_tpu_torch.ops import fast
from hfvo_tpu_torch.parallel.dist_ba import dist_local_bundle_adjustment, shard_ba_problem
from hfvo_tpu_torch.parallel.mesh import make_mesh
from hfvo_tpu_torch.parallel.multiseq import BatchTracker
from hfvo_tpu_torch.solve.global_ba import run_global_ba
from hfvo_tpu_torch.system import VOSystem
from hfvo_tpu_torch.testing import loop_map
from hfvo_tpu_torch.testing.ba_fixture import synthetic_ba_problem
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
    """Every module of the port imports with `jax` and `hfvo_tpu` blocked
    (and matplotlib, which the card's machine lacks: the drawers import it
    when they draw), the facade and IO modules among them."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['hfvo_tpu'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import hfvo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(hfvo_tpu_torch.__path__, 'hfvo_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) > 20, names\n"
        "assert 'hfvo_tpu_torch.parallel.multiseq' in names, names\n"
        "new = ['cli', 'eval_cli', 'stream_cli', 'io.tum', 'io.yaml_config', 'io.stream', 'native',\n"
        "       'vomap.checkpoint', 'bow.dbow2', 'viz.drawers', 'viz.live', 'solve.initializer',\n"
        "       'parallel.mesh', 'parallel.dist_lm', 'parallel.dist_pose_graph', 'parallel.dist_gba',\n"
        "       'parallel.dist_ba', 'parallel.multihost', 'bow.sharded_db', 'testing.ba_fixture',\n"
        "       'testing.dist_worker']\n"
        "assert all('hfvo_tpu_torch.' + n in names for n in new), names\n"
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
    # The static mask is ported: a 640x480 mask file, resized to the
    # camera by PIL's nearest rule.
    "static_mask_path": lambda: (_with_tracking(static_mask_path="mask.png"), {}, "runs"),
}


@pytest.mark.parametrize("option", sorted(_OUT_OF_SLICE))
def test_out_of_slice_raises(option, two_frames, tmp_path):
    cfg, kw, expect = _OUT_OF_SLICE[option]()
    if option == "static_mask_path":
        from PIL import Image

        mask = np.full((480, 640), 255, np.uint8)
        mask[:, :160] = 0
        Image.fromarray(mask).save(tmp_path / "mask.png")
        cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, static_mask_path=str(tmp_path / "mask.png")))
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
def test_facade_options_out_of_slice_raise(option, tmp_path):
    """The facade's options (once refused) construct: a settings YAML gives
    the configuration, a DBoW2 vocabulary becomes the active one (and is
    reset here), the live viewer serves and shuts down."""
    from hfvo_tpu_torch.bow import dbow2, vocab

    if option == "settings_yaml":
        p = tmp_path / "s.yaml"
        p.write_text("%YAML:1.0\nCamera.fx: 500.0\nDepthMapFactor: 1000.0\n")
        system = VOSystem(None, "cpu", use_local_ba=False, use_loop_closing=False, settings_yaml=str(p))
        assert system.cfg.camera.fx == 500.0 and system.cfg.tracking.depth_map_factor == 1000.0
        return
    if option == "vocabulary_path":
        rng = np.random.default_rng(0)
        desc = rng.integers(0, 2**32, (200, 8), dtype=np.uint64).astype(np.uint32)
        p = str(tmp_path / "voc.txt")
        dbow2.save_dbow2_text(p, dbow2.build_vocabulary(desc, k=4, L=2))
        try:
            VOSystem(points_only(tum3_config()), "cpu", use_local_ba=False,
                     use_loop_closing=False, vocabulary_path=p)
            assert vocab._ACTIVE_TREE is not None
        finally:
            vocab.set_vocabulary(None)
        return
    system = VOSystem(points_only(tum3_config()), "cpu", use_local_ba=False,
                      use_loop_closing=False, use_viewer=True)
    try:
        assert system.viewer.port > 0 and system.tracker.viz_enabled
        assert system.viewer.state_dict()["frame_id"] == -1
    finally:
        system.shutdown()
    assert system.viewer is None


def test_async_tracking_out_of_slice_raises():
    """track_rgbd_async (once refused) runs: an uninitialized tracker
    tracks the frame synchronously (here an empty frame, which cannot
    initialize) and returns its result."""
    tracker = Tracker(points_only(tum3_config()).replace(camera=half_camera()), "cpu",
                      use_local_ba=False, use_loop_closing=False)
    res = tracker.track_rgbd_async(np.zeros((240, 320), np.float32), np.zeros((240, 320), np.float32))
    assert [r.state for r in res] == [TrackState.NOT_INITIALIZED] and tracker.flush() == []


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
    # The distributed layer's entry points, on a 1-rank mesh.
    "ShardedKeyFrameDatabase": lambda cfg, **kw: ShardedKeyFrameDatabase(make_mesh(), 8, **kw),
    "dist_local_bundle_adjustment": lambda cfg, **kw: dist_local_bundle_adjustment(
        make_mesh(), shard_ba_problem(synthetic_ba_problem(cfg.camera, 1, pts_per_block=8)[0], 1), cfg.camera, **kw),
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
    # A 1-rank mesh (no process group) runs as no mesh, as the JAX
    # package's BatchTracker on a 1-device 'seq' mesh.
    "mesh": ({"mesh": make_mesh()}, None),
    # Local BA after a batch keyframe is ported: it constructs and steps.
    "use_local_ba": ({"use_local_ba": True}, None),
    # The pipelined batch path is ported: it constructs and steps.
    "pipeline_depth": ({"pipeline_depth": 2}, None),
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
        bt = make(cfg)
        if option == "mesh":
            assert bt.mesh.size == 1 and len(bt.trackers) == 2
        else:
            assert all(tr.use_local_ba for tr in bt.trackers) if option == "use_local_ba" else bt.pipeline_depth == 2
        return
    with pytest.raises(NotImplementedError, match=where):
        make(cfg)


def test_distributed_local_ba_out_of_slice_raises():
    """LocalMapper(use_distributed=True) (once refused) runs, without a
    process group, the single-device local BA, as the JAX package's on one
    device: on an empty map it does not run, on the loop map it gives the
    single-device result bit for bit."""
    from hfvo_tpu_torch.mapping.local_mapping import LocalMapper

    cfg = tum3_config()
    assert not LocalMapper(cfg, VOMap(cfg), "cpu", use_distributed=True).run_local_ba()
    cfg = cfg.replace(cap=dataclasses.replace(cfg.cap, local_points=2048, ba_edges=4096))
    maps = []
    for use_distributed in (False, True):
        vm = VOMap(cfg)
        loop_map.build_loop_map(vm, KeyFrameDatabase(cfg.cap.keyframes), cfg)
        assert LocalMapper(cfg, vm, "cpu", use_distributed=use_distributed).run_local_ba()
        maps.append(vm)
    np.testing.assert_array_equal(maps[1].keyframes.T_cw, maps[0].keyframes.T_cw)
    np.testing.assert_array_equal(maps[1].points.X_w, maps[0].points.X_w)


def test_batch_async_and_lost_out_of_slice_raise(two_frames):
    """The async batch entry points (once refused) run: with a sequence not
    OK, track_batch_async flushes and steps the batch synchronously; a LOST
    sequence (once refused) is stepped inside the batch from its motion
    model, with no relocalization, as the JAX package's batch steps it."""
    bt = BatchTracker(points_only(tum3_config()).replace(camera=half_camera()), n_seq=2, device="cpu",
                      use_local_ba=False)
    frames = [np.zeros((240, 320), np.float32)] * 2
    res = bt.track_batch_async(frames, frames)
    assert [r.state for r in res] == [TrackState.NOT_INITIALIZED] * 2
    assert bt.flush() == []
    assert [tr.frame_id for tr in bt.trackers] == [0, 0]
    bt = BatchTracker(points_only(tum3_config()).replace(camera=half_camera()), n_seq=2, device="cpu",
                      use_local_ba=False)
    T_wc, grays, depths = two_frames
    bt.track_batch([grays[0]] * 2, [depths[0]] * 2, [np.linalg.inv(T_wc[0])] * 2)
    bt.trackers[1].state = TrackState.LOST
    res = bt.track_batch([grays[1]] * 2, [depths[1]] * 2)
    assert [tr.frame_id for tr in bt.trackers] == [1, 1]
    assert [r.state for r in res] == [TrackState.OK, TrackState.OK]
    assert "relocalize" not in bt.trackers[1].stage_times
