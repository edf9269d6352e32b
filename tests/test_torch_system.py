"""The port's facade and entry points on a TUM directory: the CLI, the
stream server, localization mode and reset, the savers, the static mask
and the pipelined batch path. Port only (the JAX package's own tests hold
its side); the savers are held to the JAX package's formatting by calling
its saver methods on the port's system.

One module-scoped TUM directory of 8 frames of the orbit (seed 11, as
tests/test_cli_e2e.py), 8-bit gray and 16-bit depth PNGs, so that the
native and the Python loaders decode the same gray and the stream can
publish exactly what the CLI decoded. Gates:
- the CLI (`--loader native --kf-out --ply --checkpoint-out`): its saved
  trajectory equals a VOSystem fed the decoded frames within 1e-5 (two
  runs of the port on the CPU on identical frames part by ~1e-6 in
  float32 rounding), and its ATE is < 0.03 m (test_cli_e2e.py's gate);
  the checkpoint holds the map;
- stream_cli over the first 4 frames through a localhost publisher: 4
  emitted, 0 dropped, per-frame poses within 1e-4 of the CLI's (the
  stream's uint16 depth is divided by the factor, the native loader
  multiplies by its float reciprocal: the last bit of some depths
  differs, and the poses by ~7e-6);
- localization mode keeps the keyframe count and tracks OK; reset
  re-initializes;
- the savers' files equal, byte for byte, the JAX package's savers' on the
  same system;
- the static mask (tests/test_mask_reset.py:13-45 at 6 frames): every
  landmarked observation of the newest keyframe lies in the unmasked half;
- BatchTracker.track_batch_async at depths 1 and 2, 2 sequences x 5 frames
  at 320x240: as many results as frames, and each sequence's ATE < max(2 x
  its track_batch ATE, 0.02 m).
Waits on the stream server are on events; their timeouts only guard
against a hang."""
import dataclasses
import os
import socket
import threading

import numpy as np
import pytest
from PIL import Image

from hfvo_tpu.system import VOSystem as JaxVOSystem
from hfvo_tpu_torch import cli, stream_cli
from hfvo_tpu_torch import native
from hfvo_tpu_torch.config import tum3_config
from hfvo_tpu_torch.io import evaluate, trajectory, tum
from hfvo_tpu_torch.io.stream import CH_DEPTH, CH_EOF, CH_RGB, send_frame
from hfvo_tpu_torch.parallel.multiseq import BatchTracker
from hfvo_tpu_torch.system import VOSystem
from hfvo_tpu_torch.testing import synthetic as tsyn
from hfvo_tpu_torch.tracking.tracker import TrackState
from test_cli_e2e import SETTINGS
from torch_helpers import half_camera

N_FRAMES = 8


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tum_port")
    T_wc, grays, depths = tsyn.render_sequence(n=N_FRAMES, seed=11)
    tsyn.write_tum_sequence(str(d), grays, depths, SETTINGS, rgb=False)
    frames = list(tum.iterate_sequence(str(d), str(d / "assoc.txt"), 5000.0))
    return str(d), T_wc, frames


def _recording(monkeypatch):
    """Record each VOSystem.track_rgbd result (the CLIs' systems)."""
    recs = []
    orig = VOSystem.track_rgbd

    def track(self, gray, depth, ts):
        res = orig(self, gray, depth, ts)
        recs.append(res)
        return res

    monkeypatch.setattr(VOSystem, "track_rgbd", track)
    return recs


@pytest.fixture(scope="module")
def cli_run(tum_dir, tmp_path_factory):
    d, T_wc, _ = tum_dir
    out = tmp_path_factory.mktemp("cli_out")
    paths = {k: str(out / f) for k, f in (("out", "traj.txt"), ("kf", "kf.txt"),
                                         ("ply", "map.ply"), ("ck", "map.npz"))}
    mp = pytest.MonkeyPatch()
    try:
        recs = _recording(mp)
        rc = cli.main([os.path.join(d, "settings.yaml"), d, os.path.join(d, "assoc.txt"),
                       "--loader", "native", "--out", paths["out"], "--kf-out", paths["kf"],
                       "--ply", paths["ply"], "--checkpoint-out", paths["ck"], "--device", "cpu"])
    finally:
        mp.undo()
    return rc, paths, recs


def test_cli_matches_vosystem_on_the_decoded_frames(tum_dir, cli_run):
    d, T_wc, _ = tum_dir
    rc, paths, recs = cli_run
    assert rc == 0 and native.native_available()
    ts, T_est = trajectory.load_tum(paths["out"])
    assert len(ts) == N_FRAMES and all(r.state is TrackState.OK for r in recs)
    with native.NativeSequenceLoader(d, os.path.join(d, "assoc.txt"), 5000.0) as nl:
        decoded = list(nl)
    system = VOSystem(settings_yaml=os.path.join(d, "settings.yaml"), device="cpu")
    for t, g, dep in decoded:
        system.track_rgbd(g, dep, t)
    np.testing.assert_allclose(np.asarray(T_est), system.get_trajectory(), atol=1e-5, rtol=0)
    ape = evaluate.ate(np.arange(N_FRAMES) / 30.0, T_wc, np.asarray(ts), np.asarray(T_est), align="origin")
    assert ape.rmse < 0.03, ape.rmse
    kf_ts, _ = trajectory.load_tum(paths["kf"])
    assert 1 <= len(kf_ts) <= N_FRAMES
    assert open(paths["ply"]).read(3) == "ply"
    ck = np.load(paths["ck"])
    assert int(ck["meta"][3]) == N_FRAMES - 1 and ck["kf_valid"].sum() == len(kf_ts)


def test_stream_cli_matches_the_cli(tum_dir, cli_run, tmp_path, monkeypatch, capsys):
    d, _, frames = tum_dir
    recs_cli = cli_run[2]
    recs = _recording(monkeypatch)
    port = []
    ready = threading.Event()
    rc = {}

    def listening(p):
        port.append(p)
        ready.set()

    def run():
        rc["rc"] = stream_cli.main([os.path.join(d, "settings.yaml"), "--kf-out", str(tmp_path / "kf.txt"),
                                    "--out", str(tmp_path / "traj.txt"), "--device", "cpu"],
                                   listening=listening)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(timeout=300), "stream_cli never listened"  # hang guard
    sock = socket.create_connection(("127.0.0.1", port[0]), timeout=60)
    for ts, g, _ in frames[:4]:
        send_frame(sock, CH_RGB, ts, g.astype(np.uint8))
        d16 = np.asarray(Image.open(os.path.join(d, "depth", f"{ts:.6f}.png")))
        send_frame(sock, CH_DEPTH, ts + 0.002, d16)
    send_frame(sock, CH_EOF, 0.0, None)
    sock.close()
    th.join(timeout=600)  # hang guard
    assert not th.is_alive() and rc.get("rc") == 0
    assert "(sync emitted 4, dropped 0)" in capsys.readouterr().out
    assert len(recs) == 4
    for a, b in zip(recs, recs_cli[:4]):
        assert a.state is TrackState.OK
        np.testing.assert_allclose(a.T_cw, b.T_cw, atol=1e-4, rtol=0)
    assert len(trajectory.load_tum(str(tmp_path / "traj.txt"))[0]) == 4
    assert os.path.exists(tmp_path / "kf.txt")


def test_localization_mode_and_reset(tum_dir):
    _, _, frames = tum_dir
    system = VOSystem(tum3_config(), "cpu")
    for t, g, dep in frames[:3]:
        system.track_rgbd(g, dep, t)
    n_kf = system.tracker.vomap.n_keyframes()
    system.activate_localization_mode()
    for t, g, dep in frames[3:6]:
        res = system.track_rgbd(g, dep, t)
        assert res.state is TrackState.OK and not res.is_keyframe
    assert system.tracker.vomap.n_keyframes() == n_kf  # map frozen
    system.deactivate_localization_mode()
    system.reset()
    assert system.tracker.vomap.n_keyframes() == 0 and system.times.n_frames == 0
    res = system.track_rgbd(frames[0][1], frames[0][2], 0.0)
    assert res.state is TrackState.OK and system.tracker.vomap.n_keyframes() == 1


def test_savers_write_the_jax_formats(tum_dir, tmp_path):
    _, _, frames = tum_dir
    system = VOSystem(tum3_config(), "cpu", use_local_ba=False)
    for t, g, dep in frames[:3]:
        system.track_rgbd(g, dep, t)
    for name in ("save_trajectory_tum", "save_keyframe_trajectory_tum",
                 "save_trajectory_kitti", "save_point_cloud_ply"):
        p, q = str(tmp_path / f"{name}.port"), str(tmp_path / f"{name}.jax")
        getattr(system, name)(p)
        getattr(JaxVOSystem, name)(system, q)  # the JAX package's saver on the same arrays
        assert open(p, "rb").read() == open(q, "rb").read(), name
    assert "mean local BA time" in system.extract_times()


def test_static_mask_keeps_observations_in_the_unmasked_half(tum_dir, tmp_path):
    _, _, frames = tum_dir
    cfg0 = tum3_config()
    H, W = cfg0.camera.height, cfg0.camera.width
    mask = np.full((H, W), 255, np.uint8)
    mask[:, : W // 2] = 0  # left half excluded
    Image.fromarray(mask).save(tmp_path / "mask.png")
    cfg = cfg0.replace(tracking=dataclasses.replace(cfg0.tracking, static_mask_path=str(tmp_path / "mask.png")))
    system = VOSystem(cfg, "cpu", use_local_ba=False, use_loop_closing=False)
    for t, g, dep in frames[:6]:
        assert system.track_rgbd(g, dep, t).state is TrackState.OK
    vm = system.tracker.vomap
    s = vm.newest_kf_slot
    kf = vm.keyframes
    assert kf.frame_id[s] > 0  # a tracked frame's keyframe, not the init's
    obs_ok = kf.obs_valid[s] & (kf.point_id[s] >= 0)
    assert obs_ok.sum() > 50
    assert (kf.obs[s][obs_ok, 0] >= W // 2 - 1).all()
    # Lines: no new keyframe segment has its midpoint in the masked half.
    kl = vm.kf_lines
    mid = 0.5 * (kl.p0[s] + kl.p1[s])
    assert (mid[kl.seg_valid[s], 0] >= W // 2 - 1).all()


@pytest.fixture(scope="module")
def batch_frames():
    return [tsyn.render_sequence(n=5, intr=half_camera(), seed=s) for s in (0, 7)]


def _ate(T_wc, est):
    ts = np.arange(len(est)) / 30.0
    return evaluate.ate(ts, T_wc[: len(est)], ts, est, align="origin").rmse


@pytest.mark.parametrize("depth", [1, 2])
def test_batch_async_tracks_as_well_as_track_batch(batch_frames, depth):
    cfg = tum3_config().replace(camera=half_camera())
    T0 = [np.linalg.inv(f[0][0]).astype(np.float32) for f in batch_frames]
    ref = BatchTracker(cfg, 2, "cpu", use_local_ba=False)
    for i in range(5):
        ref.track_batch([f[1][i] for f in batch_frames], [f[2][i] for f in batch_frames], T0)
    bt = BatchTracker(cfg, 2, "cpu", use_local_ba=False, pipeline_depth=depth)
    n_res = len([r for r in bt.track_batch([f[1][0] for f in batch_frames],
                                           [f[2][0] for f in batch_frames], T0) if r is not None])
    for i in range(1, 5):
        n_res += len(bt.track_batch_async([f[1][i] for f in batch_frames], [f[2][i] for f in batch_frames]))
    n_res += len(bt.flush())
    assert n_res == 2 * 5
    for s, f in enumerate(batch_frames):
        ate_ref = _ate(f[0], ref.trackers[s].get_trajectory())
        ate = _ate(f[0], bt.trackers[s].get_trajectory())
        assert len(bt.trackers[s].get_trajectory()) == 5
        assert ate < max(2 * ate_ref, 0.02), (s, ate, ate_ref)
    assert set(bt.step_times) >= {"prep", "upload", "dispatch", "resolve", "pull"}
