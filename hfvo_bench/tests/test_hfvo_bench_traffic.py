"""The traffic generator: deterministic in the seed, a seamless loop, and
its frozen renderer equal to the program's at the copy's commit."""
import json
import math

import numpy as np
import pytest
import torch

from hfvo_bench import gen

from .conftest import ROOT

CAM = json.loads((ROOT / "hfvo_bench/configs/tum3_vo.json").read_text())["vo_config"]["camera"]


def _params(name="orbit_textured"):
    return gen.load_params(ROOT / "hfvo_bench", name)


@pytest.mark.parametrize("name", ["orbit_textured", "orbit_low_texture"])
def test_traffic_is_deterministic_in_the_seed(name):
    p = _params(name)
    big = 2**31 + 12345  # the driver's seeds pass 32 signed bits
    a = gen.build(name, p, CAM, 30.0, 8, big, "cpu", n_render=3)
    b = gen.build(name, p, CAM, 30.0, 8, big, "cpu", n_render=3)
    c = gen.build(name, p, CAM, 30.0, 8, big + 1, "cpu", n_render=3)
    assert np.array_equal(a.gray, b.gray) and np.array_equal(a.depth, b.depth) and a.starts == b.starts
    assert not np.array_equal(a.depth, c.depth)  # the seed draws the sensor noise
    # The mix names the room and the phase: the same scene for every seed.
    assert np.array_equal(a.gray, c.gray) and a.starts == c.starts
    assert a.gray.dtype == np.uint8 and a.depth.dtype == np.uint16


def test_loop_is_seamless():
    tr = _params()["trajectory"]
    assert gen.period_of(tr["step_rad"]) == pytest.approx(tr["period_frames"], abs=1e-9)
    T = gen.orbit_trajectory(tr["period_frames"] + 1, tr["radius"], tr["yaw_amp"], tuple(tr["center"]),
                             tr["step_rad"])
    assert np.allclose(T[tr["period_frames"]], T[0], atol=1e-6)
    steps = np.linalg.norm(np.diff(T[:, :3, 3], axis=0), axis=1)
    wrap = np.linalg.norm(T[0, :3, 3] - T[tr["period_frames"] - 1, :3, 3])
    assert wrap <= steps[:-1].max() + 1e-6
    rot = [np.arccos(np.clip((np.trace(T[i, :3, :3].T @ T[i + 1, :3, :3]) - 1) / 2, -1, 1)) for i in range(len(T) - 1)]
    wrap_rot = np.arccos(np.clip((np.trace(T[-2, :3, :3].T @ T[0, :3, :3]) - 1) / 2, -1, 1))
    assert wrap_rot <= max(rot[:-1]) + 1e-6


def test_sequences_read_the_period_at_their_phases():
    p = _params()
    t = gen.build("orbit_textured", p, CAM, 30.0, 8, 7, "cpu", n_render=2)
    stride = p["sequences"]["phase_stride_frames"]
    assert [(t.starts[s] - t.starts[0]) % 2 for s in range(8)] == [(s * stride) % 2 for s in range(8)]
    assert t.frame(3, t.period) == t.frame(3, 0)


@pytest.mark.parametrize("low", [False, True])
def test_frozen_renderer_equals_the_program(low):
    from hfvo_tpu_torch.config import tum3_config
    from hfvo_tpu_torch.testing import synthetic

    assert np.array_equal(gen.make_room_textures(5, True, low), synthetic.make_room_textures(5, True, low))
    T = gen.orbit_trajectory(40)
    assert np.array_equal(T, synthetic.orbit_trajectory(40))
    tex = torch.from_numpy(gen.make_room_textures(5, True, low))
    scene = synthetic.make_room(5, True, low)
    for i in (0, 17, 39):
        g, d = gen.render(tex, CAM, torch.from_numpy(T[i]))
        g0, d0 = synthetic.render(scene, tum3_config().camera, torch.from_numpy(T[i]))
        assert torch.equal(g, g0) and torch.equal(d, d0)


def test_sensor_model_matches_its_definition():
    """Rounded uint8 gray; millimetre depth within the noise model, with
    holes; no hole where the draw has none."""
    gen_ = torch.Generator().manual_seed(0)
    gray = torch.full((2, 48, 64), 100.4)
    depth = torch.full((2, 48, 64), 2.0)
    sensor = dict(quad_sigma=0.002, n_holes=2, hole_size=9, depth_scale=1000.0)
    g, d = gen.sensorize(gray, depth, gen_, sensor)
    assert g.dtype == torch.uint8 and bool((g == 100).all())
    valid = d[d > 0].double()
    assert float((valid - 2000).abs().max()) < 6 * 0.002 * 4 * 1000 + 1
    assert 0 < int((d == 0).sum()) < d.numel() // 2
    _, d_nohole = gen.sensorize(gray, depth, torch.Generator().manual_seed(0), dict(sensor, n_holes=0))
    assert int((d_nohole == 0).sum()) == 0
    assert math.isclose(float(d_nohole.double().std()), 8.0, rel_tol=0.2)
