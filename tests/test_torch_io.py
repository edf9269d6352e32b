"""The port's IO against hfvo_tpu's: the settings YAML, the TUM association
files and frame loader, the native C++ loader, the static mask reader, the
stream synchronizer and socket transport, and the evaluation CLI.

Inputs are seeded numpy arrays written to small files (160x120 images).
Every comparison is exact (bit-equal arrays, equal dataclass fields, equal
printed text), except the native loader against the Python loader, which
decode gray differently (libpng with float BT.601 weights against PIL's
integer luma) and are held to the JAX package's own tolerance
(tests/test_native_loader.py: depth 1e-6, gray within 1 level)."""
import dataclasses
import os
import socket
import threading

import numpy as np
import pytest
from PIL import Image

from hfvo_tpu import eval_cli as jeval_cli
from hfvo_tpu import native as jnative
from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.io import stream as jstream
from hfvo_tpu.io import trajectory as jtraj
from hfvo_tpu.io import tum as jtum
from hfvo_tpu.io import yaml_config as jyaml
from hfvo_tpu.tracking.tracker import Tracker as JaxTracker
from hfvo_tpu_torch import eval_cli as teval_cli
from hfvo_tpu_torch import native as tnative
from hfvo_tpu_torch.io import stream as tstream
from hfvo_tpu_torch.io import tum as ttum
from hfvo_tpu_torch.io import yaml_config as tyaml
from test_cli_e2e import SETTINGS as CLI_SETTINGS

SYSTEM_SETTINGS = (
    "%YAML:1.0\n\n# camera\nCamera.fx: 517.306408\nCamera.fy: 516.469215\n"
    "Camera.cx: 318.643040\nCamera.cy: 255.313989\nCamera.k1: 0.262383\n"
    "Camera.bf: 40.0\nCamera.fps: 30.0\nORBextractor.nFeatures: 1000\n"
    "ORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: 8\n"
    "ORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n"
    "DepthMapFactor: 5000.0\nPlane.AngleInfo: 0.5\nPlane.Chi: 100\n"
)  # tests/test_system.py::test_yaml_config_parsing


def _fields(cfg):
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else tuple(v)
                     if isinstance(v, tuple) else v)
            for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}


@pytest.mark.parametrize("text", [SYSTEM_SETTINGS, CLI_SETTINGS,
                                  "%YAML:1.0\nCamera.fps: 0\nThDepth: 35\nMask.path: \"nope.png\"\n"])
def test_yaml_settings_give_equal_configs(tmp_path, text):
    p = str(tmp_path / "settings.yaml")
    open(p, "w").write(text)
    assert _fields(tyaml.config_from_yaml(p)) == _fields(jyaml.config_from_yaml(p))
    assert tyaml.parse_opencv_yaml(p) == jyaml.parse_opencv_yaml(p)


def test_yaml_mask_path_rule(tmp_path, monkeypatch):
    """Mask.path absent: ./masks/mask.png is picked up from the working
    directory when present; Mask.path naming a missing file gives none."""
    p = str(tmp_path / "settings.yaml")
    open(p, "w").write("%YAML:1.0\nDepthMapFactor: 5000.0\n")
    monkeypatch.chdir(tmp_path)
    assert tyaml.config_from_yaml(p).tracking.static_mask_path is None
    os.makedirs("masks")
    Image.fromarray(np.full((4, 4), 255, np.uint8)).save("masks/mask.png")
    for mod in (tyaml, jyaml):
        assert mod.config_from_yaml(p).tracking.static_mask_path == "./masks/mask.png"
    open(p, "a").write("Mask.path: missing.png\n")
    for mod in (tyaml, jyaml):
        assert mod.config_from_yaml(p).tracking.static_mask_path is None


def test_association_parsing_and_associate(tmp_path):
    a = tmp_path / "assoc.txt"
    a.write_text("# header\n\n0.0 rgb/a.png 0.001 depth/a.png\nbad line\n"
                 "x rgb/b.png 1 depth/b.png\n0.033 rgb/c.png 0.034 depth/c.png extra\n")
    want, got = jtum.load_association(str(a)), ttum.load_association(str(a))
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and len(got) == 2
    rng = np.random.default_rng(0)
    t_rgb = np.arange(20) / 30.0
    t_dep = t_rgb + rng.uniform(-0.03, 0.03, 20)
    (tmp_path / "rgb.txt").write_text("# rgb\n" + "".join(f"{t:.6f} rgb/{i}.png\n" for i, t in enumerate(t_rgb)))
    (tmp_path / "depth.txt").write_text("".join(f"{t:.6f} depth/{i}.png\n" for i, t in enumerate(t_dep)))
    args = (str(tmp_path / "rgb.txt"), str(tmp_path / "depth.txt"))
    want, got = jtum.associate(*args), ttum.associate(*args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and 0 < len(got) < 20


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """4 frames of 160x120: RGB and gray 8-bit PNGs (alternating), 16-bit
    depth PNGs, association file."""
    d = tmp_path_factory.mktemp("tum_io")
    os.makedirs(d / "rgb")
    os.makedirs(d / "depth")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(4):
        ts = i / 30.0
        img = rng.integers(0, 255, (120, 160, 3) if i % 2 == 0 else (120, 160), dtype=np.uint8)
        Image.fromarray(img).save(d / "rgb" / f"{ts:.6f}.png")
        dep = (rng.uniform(0.5, 4.0, (120, 160)) * 5000).astype(np.uint16)
        Image.fromarray(dep).save(d / "depth" / f"{ts:.6f}.png")
        lines.append(f"{ts:.6f} rgb/{ts:.6f}.png {ts:.6f} depth/{ts:.6f}.png")
    (d / "assoc.txt").write_text("\n".join(lines) + "\n")
    return str(d)


def test_iterate_sequence_bit_equal(tum_dir):
    a = os.path.join(tum_dir, "assoc.txt")
    want = list(jtum.iterate_sequence(tum_dir, a, 5000.0))
    got = list(ttum.iterate_sequence(tum_dir, a, 5000.0))
    assert len(got) == len(want) == 4
    for (tg, gg, dg), (tw, gw, dw) in zip(got, want):
        assert tg == tw and gg.dtype == gw.dtype == np.float32
        np.testing.assert_array_equal(gg, gw)
        np.testing.assert_array_equal(dg, dw)


def test_native_loader_matches_both_jax_loaders(tum_dir):
    assert tnative.native_available(), tnative.build_error()
    assert jnative.native_available(), jnative.build_error()
    assert tnative.library_path().parent.name == "hfvo_tpu_torch"  # build/hfvo_tpu_torch/
    a = os.path.join(tum_dir, "assoc.txt")
    with tnative.NativeSequenceLoader(tum_dir, a, 5000.0, max_hw=(120, 160)) as nl:
        assert len(nl) == 4
        got = list(nl)
    jl = jnative.NativeSequenceLoader(tum_dir, a, 5000.0, max_hw=(120, 160))
    want = list(jl)
    jl.close()
    py = list(ttum.iterate_sequence(tum_dir, a, 5000.0))
    assert len(got) == len(want) == 4
    for (tg, gg, dg), (tw, gw, dw), (_, gp, dp) in zip(got, want, py):
        assert tg == tw
        np.testing.assert_array_equal(gg, gw)
        np.testing.assert_array_equal(dg, dw)
        np.testing.assert_allclose(dg, dp, atol=1e-6, rtol=0)
        assert np.abs(gg - gp).max() <= 1.0
    with pytest.raises(RuntimeError):
        tnative.NativeSequenceLoader(tum_dir, os.path.join(tum_dir, "nope.txt"))


@pytest.mark.parametrize("shape", [(480, 640), (240, 320), (97, 131)])
def test_static_mask_reader_matches_the_jax_tracker(tmp_path, shape):
    rng = np.random.default_rng(shape[1])
    m = np.where(rng.random(shape) < 0.5, 0, rng.integers(1, 256, shape)).astype(np.uint8)
    m[:, : shape[1] // 3] = 0
    p = tmp_path / "mask.png"
    Image.fromarray(m).save(p)
    cfg = jax_tum3()
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, static_mask_path=str(p)))
    want = np.asarray(JaxTracker(cfg, use_local_ba=False, use_loop_closing=False)._mask_dev)
    got = ttum.read_mask(str(p), cfg.camera.height, cfg.camera.width)
    np.testing.assert_array_equal(got, want)


def _sync_run(mod, pushes, **kw):
    out = []
    sync = mod.ApproximateTimeSync(lambda ts, a, b: out.append((ts, int(a[0]), int(b[0]))), **kw)
    for ch, t, v in pushes:
        (sync.push_rgb if ch == 0 else sync.push_depth)(t, np.array([v]))
    sync.flush()
    return out, sync.n_emitted, sync.n_dropped


def _protocols():
    """The stamp streams of tests/test_stream.py:31-95 and seeded variants."""
    out = []
    out.append(([(c, i / 30.0, 100 * c + i) for i in range(10) for c in (0, 1)], {}))
    rng = np.random.default_rng(0)
    out.append(([(c, i / 30.0 + c * (0.005 + rng.uniform(-2e-3, 2e-3)), i) for i in range(12) for c in (0, 1)], {}))
    out.append(([p for i in range(10) for p in ((0, i / 30.0, i), (1, i / 30.0 + 0.001, i)) if not (p[0] == 1 and i == 4)],
                {"max_interval": 0.016}))
    order = [0, 2, 1, 3, 5, 4, 6, 7]
    out.append(([(0, i / 30.0, i) for i in order] + [(1, i / 30.0 + 0.002, i) for i in range(8)], {}))
    out.append(([(0, i / 30.0, i) for i in range(50)] + [(1, 49 / 30.0, 49)], {"queue_size": 4}))
    for seed in (1, 2, 3):
        r = np.random.default_rng(seed)
        ev = []
        for i in range(60):
            if r.random() > 0.1:
                ev.append((0, i / 30.0 + r.normal(0, 0.004), i))
            if r.random() > 0.1:
                ev.append((1, i / 30.0 + 0.003 + r.normal(0, 0.004), 1000 + i))
        perm = np.arange(len(ev))
        for j in range(0, len(ev) - 3, 7):  # local reordering
            perm[j], perm[j + 2] = perm[j + 2], perm[j]
        out.append(([ev[k] for k in perm], {"queue_size": 6, "max_interval": 0.02}))
    return out


@pytest.mark.parametrize("case", range(8))
def test_approximate_time_sync_matches_jax(case):
    pushes, kw = _protocols()[case]
    assert _sync_run(tstream, pushes, **kw) == _sync_run(jstream, pushes, **kw)


@pytest.mark.parametrize("publisher", [tstream, jstream])
def test_socket_round_trip(publisher):
    """A port server fed by the port's and the JAX package's publishers."""
    got = []
    done = threading.Event()
    server = tstream.FrameStreamServer(lambda ts, rgb, d: got.append((ts, rgb.copy(), d.copy())))
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=30)
    rng = np.random.default_rng(1)
    sent = []
    for i in range(5):
        t = i / 30.0
        rgb = rng.integers(0, 255, (48, 64, 3) if i % 2 else (48, 64), dtype=np.uint8)
        depth = rng.integers(0, 5000, (48, 64), dtype=np.uint16)
        publisher.send_frame(sock, publisher.CH_RGB, t, rgb)
        publisher.send_frame(sock, publisher.CH_DEPTH, t, depth)
        sent.append((t, rgb, depth))
    publisher.send_frame(sock, publisher.CH_EOF, 0.0, None)
    assert server.wait(timeout=60)  # guards against a hang only
    sock.close()
    done.set()
    assert len(got) == 5 and server.sync.n_dropped == 0
    for (t, rgb, depth), (ts, r, d) in zip(sent, got):
        assert ts == t and r.dtype == np.uint8 and d.dtype == np.uint16
        np.testing.assert_array_equal(r, rgb)
        np.testing.assert_array_equal(d, depth)


def test_eval_cli_prints_the_jax_text(tmp_path, capsys):
    rng = np.random.default_rng(3)
    n = 40
    ts = np.arange(n) / 30.0
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, 3] = np.cumsum(rng.normal(0, 0.01, (n, 3)), 0)
    E = T.copy()
    E[:, :3, 3] += rng.normal(0, 0.005, (n, 3))
    gt, est = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    jtraj.save_tum(gt, ts, T)
    jtraj.save_tum(est, ts[2:], E[2:])
    (tmp_path / "pairs.txt").write_text(f"{gt} {est}\n{gt} {gt}\n")
    for argv in ([gt, est], [gt, est, "--align", "umeyama"], ["--batch", str(tmp_path / "pairs.txt")]):
        assert jeval_cli.main(argv) == 0
        want = capsys.readouterr().out
        assert teval_cli.main(argv) == 0
        assert capsys.readouterr().out == want and "APE rmse" in want
