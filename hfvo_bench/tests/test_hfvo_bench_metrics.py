"""Metric arithmetic, the roofline counts, and discovery by name."""
import json
import shutil

import pytest

from hfvo_bench import roofline, run, stats
from hfvo_bench.run import Context

from .conftest import ROOT


def _reader(name):
    return run.load_module(ROOT / "hfvo_bench" / "metrics" / f"{name}.py", f"t_{name}")


def test_rate_is_all_frames_over_all_seconds():
    fps = _reader("frames_per_s")
    steady = Context(window_s=10.0, n_returned=30)
    stalled = Context(window_s=12.0, n_returned=30)  # the same frames and a 2 s stall
    assert fps.read(steady) == 3.0
    assert fps.read(stalled) == pytest.approx(2.5)


def test_p90_is_over_all_samples_and_a_stall_moves_it():
    p90 = _reader("frame_latency_ms_p90.host")
    lat = [300.0] * 100
    assert p90.read(Context(host=dict(latencies_ms=lat))) == 300.0
    stalled = lat[:85] + [2300.0] * 15  # a 2 s stall delays 15 frames
    assert p90.read(Context(host=dict(latencies_ms=stalled))) == 2300.0
    # Not a median of chunk percentiles: chunks of 10 would each read 300
    # for the first 80 samples.
    assert stats.percentile(stalled, 90) == 2300.0
    assert stats.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5
    assert stats.percentile([], 90) is None
    assert p90.read(Context(host=dict(latencies_ms=[]))) is None


def test_host_stage_readers():
    ctx = Context(host=dict(stages={"fused_step": (3.0, 10), "local_ba": (0.9, 5), "kf_insert": (0.1, 2),
                                    "loop_detect": (0.2, 2), "relocalize": (5.0, 1)},
                            ba_runs=3, frames=10, latencies_ms=[1.0, 3.0], resolve_s=[0.2, 0.4]))
    assert _reader("fused_step_ms").read(ctx) == pytest.approx(300.0)
    assert _reader("local_ba_ms").read(ctx) == pytest.approx(300.0)  # per run BA counted, not per call
    assert _reader("keyframe_ms_per_frame").read(ctx) == pytest.approx(120.0)
    assert _reader("resolve_wait_ms").read(ctx) == pytest.approx(300.0)
    assert _reader("frame_ms_p50").read(ctx) == 2.0
    none = Context(host=dict(stages={}, ba_runs=0, frames=0, latencies_ms=[], resolve_s=[]))
    for name in ("fused_step_ms", "local_ba_ms", "keyframe_ms_per_frame", "resolve_wait_ms", "frame_ms_p50"):
        assert _reader(name).read(none) is None


def test_roofline_counts():
    # One K1b launch over the 8 levels of one 480x640 frame at S = 1.
    from hfvo_bench.reference import pyramid

    shapes = [(1,) + s for s in pyramid.shapes(480, 640, 8, 1.2)]
    px = sum(h * w for _, h, w in shapes)
    assert px == 950_532  # chip_smoke.py's count for K1
    b, o = roofline.fast_launch(shapes)
    assert (b, o) == (8.0 * px, 2 * 16 * 4.0 * px)
    ms, by = roofline.bound(b, o)
    assert by == "bytes" and ms == pytest.approx(8.0 * px / 3.35e9)
    # K3 on one 480x640 frame: 70 tiles.
    b, o = roofline.hough_launch((480, 640), 1000)
    assert b == 8.0 * 70 * 64 * 64 + 4.0 * 70 * 36 * 48
    assert o == 3.0 * 70 * 64 * 64 + 8.0 * 3 * 1000
    b8, _ = roofline.hough_launch((8, 480, 640), 0)
    assert b8 == 8 * roofline.hough_launch((480, 640), 0)[0]


def test_trace_readers():
    from hfvo_bench import trace

    evs = [(0.0, 10.0, "void fast_levels_kernel<2>(x)", 1), (5.0, 20.0, "k", 2), (40.0, 50.0, "hough_vote_kernel", 3)]
    assert trace.busy_ms(trace.device_spans(evs)) == pytest.approx(0.030)
    assert trace.kernel_time(evs, roofline.FAST_KERNEL) == (1, 10e-6)
    ctx = Context(trace=dict(events=evs, window_s=100e-6, busy_s=30e-6, frames=2,
                             fast_launches=[[(1, 480, 640)]], hough_launches=[((1, 480, 640), 10)]))
    assert _reader("device_idle_pct").read(ctx) == pytest.approx(70.0)
    assert _reader("device_ops_per_frame").read(ctx) == 1.5
    assert _reader("fast_roofline_pct").read(ctx) == pytest.approx(
        100 * roofline.bound(*roofline.fast_launch([(1, 480, 640)]))[0] / 1e3 / 10e-6)
    gaps = trace.idle_gaps(evs)
    assert gaps == [[f"after k / before hough_vote_kernel", pytest.approx(20e-6)]]


def test_a_cell_is_found_by_name_from_files_alone(tmp_path):
    """A dummy configuration, traffic mix, metric, limits file and cell
    added as files and BENCHMARK.json entries are found without an edit to
    a file that is there."""
    shutil.copytree(ROOT / "hfvo_bench", tmp_path / "hfvo_bench")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "hfvo_bench"
    (b / "configs" / "dummy_cfg.json").write_text((b / "configs" / "tum3_vo.json").read_text())
    (b / "traffic" / "dummy_mix.json").write_text((b / "traffic" / "orbit_textured.json").read_text())
    (b / "limits" / "dummy_cell.json").write_text((b / "limits" / "vo_orbit.json").read_text())
    (b / "metrics" / "dummy_metric.py").write_text("def read(ctx):\n    return 42.0\n")
    spec["configs"].append(dict(spec["configs"][0], name="dummy_cfg", file="hfvo_bench/configs/dummy_cfg.json"))
    spec["workloads"].append(dict(name="dummy_cell", config="dummy_cfg", traffic="dummy_mix", chips=1, why="test"))
    spec["per_layer"].append(dict(name="dummy_metric", unit="x", better="higher", source="host_clock",
                                  layer="facade", moves="frames_per_s", workloads=["dummy_cell"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    found = run.discover(tmp_path, "dummy_cell", trace=1)
    assert found["traffic"]["room"] == json.loads((b / "traffic" / "orbit_textured.json").read_text())["room"]
    assert found["driver"].__name__.endswith("vo_system")
    assert found["readers"]["dummy_metric"].read(None) == 42.0
    assert "fast_roofline_pct" not in found["readers"]  # not listed for the dummy cell
    assert found["limits"]["fast_max_abs_err"] == 0
