"""The port's span-and-counter recorder (`hfvo_tpu_torch.tracing`), on the
CPU: the off path feeds the stage timers and records nothing; the on path
gives a consistent span tree over VOSystem and the pipelined batch, counts
host syncs against the innermost span, and stamps spans on the profiler's
clock; the attribution of a device trace to the spans sums exactly; the
facade's local BA time is the BA's own. Port only: small frames (320x240),
a few of them."""
import json
import time
import types
import warnings

import numpy as np
import pytest
import torch

from hfvo_tpu_torch import cli, tracing
from hfvo_tpu_torch.bow.database import KeyFrameDatabase
from hfvo_tpu_torch.config import Capacities, tum3_config
from hfvo_tpu_torch.mapping.local_mapping import LocalMapper
from hfvo_tpu_torch.mapping.loop_closing import LoopCloser
from hfvo_tpu_torch.parallel.multiseq import BatchTracker
from hfvo_tpu_torch.system import VOSystem
from hfvo_tpu_torch.testing import loop_map, synthetic
from hfvo_tpu_torch.tracking.tracker import Tracker, TrackState
from hfvo_tpu_torch.vomap.map import VOMap
from torch_helpers import half_camera


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def frames():
    return synthetic.render_sequence(n=4, intr=half_camera())


@pytest.fixture(scope="module")
def vo_run(frames):
    """Frames 0-1 with the recorder off, 2-3 with it on."""
    tracing.disable()
    tracing.drain()
    _, g, d = frames
    system = VOSystem(tum3_config().replace(camera=half_camera()), "cpu")
    for i in range(2):
        system.track_rgbd(g[i], d[i], i / 30)
    off = dict(drained=tracing.drain(), stages={k: tuple(v) for k, v in system.tracker.stage_times.items()})
    tracing.enable()
    for i in range(2, 4):
        system.track_rgbd(g[i], d[i], i / 30)
    tracing.disable()
    return system, off, tracing.drain()


def test_off_records_nothing_and_feeds_the_stage_timers(vo_run):
    system, off, _ = vo_run
    assert not off["drained"].spans and not off["drained"].counts
    assert off["stages"]["init_extract"][1] == 1 and off["stages"]["fused_step"][1] == 1
    assert system.times.n_frames == 4
    assert system.tracker.stage_times["fused_step"][1] == 3


def test_the_span_tree_is_nested_and_shares_call_ids(vo_run):
    _, _, rec = vo_run
    by_id = {s.id: s for s in rec.spans}
    roots = [s for s in rec.spans if s.parent == 0]
    assert [s.name for s in roots] == ["facade.track"] * 2
    assert [s.ids for s in roots] == [dict(seq=0, frame=2), dict(seq=0, frame=3)]
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.call == p.call
        else:
            assert s.call == s.id
        assert s.ids["seq"] == 0
    names = {s.name for s in rec.spans}
    assert {"fused_step", "step.prepare", "step.extract", "step.match", "step.lm", "lm.round", "step.collect",
            "step.split", "step.finish", "post_track", "upload"} <= names
    lm = [s for s in rec.spans if s.name == "step.lm"]
    assert all(by_id[s.parent].name == "fused_step" for s in lm)
    assert all(by_id[s.parent].name == "step.lm" for s in rec.spans if s.name == "lm.round")


def test_fused_step_span_equals_its_stage_timer(vo_run):
    system, off, rec = vo_run
    recorded = sum(s.end_ns - s.start_ns for s in rec.spans if s.name == "fused_step") * 1e-9
    s, n = system.tracker.stage_times["fused_step"]
    assert n - off["stages"]["fused_step"][1] == 2
    assert recorded == pytest.approx(s - off["stages"]["fused_step"][0], abs=1e-6)


def test_pipelined_batch_spans_feed_its_step_lists(frames):
    cfg = tum3_config().replace(camera=half_camera())
    _, g, d = frames
    bt = BatchTracker(cfg, 2, "cpu", use_local_ba=False, pipeline_depth=1)
    T0 = [np.eye(4, dtype=np.float32)] * 2
    bt.track_batch([g[0], g[1]], [d[0], d[1]], T0)
    tracing.enable()
    n = 0
    for i in (1, 2):
        n += len(bt.track_batch_async([g[i], g[i + 1]], [d[i], d[i + 1]]))
    n += len(bt.flush())
    tracing.disable()
    rec = tracing.drain()
    assert n == 4
    names = [s.name for s in rec.spans]
    for k in ("prep", "upload", "dispatch"):
        spans = [s for s in rec.spans if s.name == f"batch.{k}"]
        assert len(spans) == 2
        assert bt.step_times[k] == pytest.approx([(s.end_ns - s.start_ns) * 1e-9 for s in spans], abs=1e-6)
    assert names.count("step.collect") == 2 and len(bt.step_times["pull"]) == 2
    assert sorted({s.ids["seq"] for s in rec.spans if s.name in ("post_track", "step.finish", "step.prepare")}) == [0, 1]
    assert all(s.ids["frame"] in (1, 2) for s in rec.spans if s.name == "post_track")
    assert [s.name for s in rec.spans if s.parent == 0] == ["facade.track"] * 3


def test_the_rarer_paths_record_their_spans(frames):
    """Relocalization while LOST and a loop closure (the synthetic loop map,
    closed on the second call), which no benchmark cell reaches."""
    _, g, d = frames
    tr = Tracker(tum3_config().replace(camera=half_camera()), "cpu", auto_reset=False)
    for i in range(2):
        tr.track_rgbd(g[i], d[i])
    tr.state = TrackState.LOST
    cfg = tum3_config().replace(cap=Capacities(map_points=2048, map_lines=256, map_planes=16, keyframes=32))
    vm, db = VOMap(cfg), KeyFrameDatabase(cfg.cap.keyframes)
    loop_map.build_loop_map(vm, db, cfg)
    trk = types.SimpleNamespace(kf_db=db, mapper=LocalMapper(cfg, vm, "cpu"), invalidate_map_snapshot=lambda: None)
    lc = LoopCloser(cfg, vm, "cpu")
    tracing.enable()
    tr.track_rgbd(g[2], d[2])
    closed = [lc.detect_and_close(trk) for _ in range(2)]
    tracing.disable()
    rec = tracing.drain()
    assert closed == [False, True]
    by_id = {s.id: s for s in rec.spans}
    (reloc,) = [s for s in rec.spans if s.name == "relocalize"]
    assert by_id[reloc.parent].name == "facade.track" and reloc.ids == dict(seq=0, frame=2)
    assert [s.name for s in rec.spans if s.name.startswith("loop.")] == ["loop.close", "loop.gba"]
    assert all(s.parent == 0 for s in rec.spans if s.name.startswith("loop."))


def test_a_sync_warning_counts_against_the_innermost_span(monkeypatch):
    modes = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    shown = []
    monkeypatch.setattr(warnings, "showwarning", lambda msg, *a, **k: shown.append(str(msg)))
    tracing.enable()
    assert modes == ["warn"]
    with tracing.span("outer"):
        warnings.warn(tracing.SYNC_WARNING)
        with tracing.span("inner"):
            warnings.warn(tracing.SYNC_WARNING)
            warnings.warn(tracing.SYNC_WARNING)
            warnings.warn("something else")
        tracing.count("host_sync", 3)
    tracing.disable()
    assert modes == ["warn", 0]
    rec = tracing.drain()
    name = {s.id: s.name for s in rec.spans}
    got = {}
    for c in rec.counts:
        got[name[c.span]] = got.get(name[c.span], 0) + c.n
    assert got == {"outer": 4, "inner": 2}
    assert shown == ["something else"]
    warnings.warn("after disable")
    assert shown[-1] == "after disable"


def test_spans_share_the_profilers_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            assert tracing.enabled()  # recording follows the profiler
            with torch.profiler.record_function("marker"):
                time.sleep(0.002)
    with tracing.span("after"):
        assert not tracing.enabled()
    rec = tracing.drain()
    (outer,) = [s for s in rec.spans if s.name == "outer"]
    marks = [e for e in prof.profiler.kineto_results.events() if e.name() == "marker"]
    assert len(marks) == 1
    assert abs(marks[0].start_ns() - outer.start_ns) < 1_000_000
    assert outer.start_ns <= marks[0].start_ns() + 1_000_000 and marks[0].start_ns() < outer.end_ns


def test_totals_after_recording_stops():
    tracing.enable()
    with tracing.span("t.stage"):
        pass
    tracing.disable()
    assert tracing.totals(since_stop=True)["t.stage"] == (0.0, 0)
    for _ in range(3):
        with tracing.span("t.stage"):
            pass
    assert tracing.totals(since_stop=True)["t.stage"][1] == 3
    assert tracing.totals()["t.stage"][1] >= 4


def test_idle_and_ops_attribution_sum_exactly():
    # facade [0, 100) > step.lm [10, 60) > lm.round [20, 30); step.collect [70, 90).
    spans = [(0, 100, "facade.track"), (10, 60, "step.lm"), (20, 30, "lm.round"), (70, 90, "step.collect")]
    device = [(5, 12), (25, 27), (40, 45), (72, 74), (95, 130)]
    lo, hi = -10, 120
    idle = tracing.idle_by_span(device, spans, lo, hi)
    total_idle = sum(e - s for s, e in tracing.idle_intervals(device, lo, hi))
    assert total_idle == 130 - (7 + 2 + 5 + 2 + 25)
    assert sum(idle.values()) == total_idle
    # Idle [-10, 5), [12, 25), [27, 40), [45, 72), [74, 95), each split at
    # the span boundaries.
    assert idle == {tracing.OUTSIDE: 10, "facade.track": 5 + 10 + 5, "step.lm": 8 + 10 + 15,
                    "lm.round": 5 + 3, "step.collect": 2 + 16}
    segs = tracing.innermost_segments(spans, lo, hi)
    assert segs[0][0] == lo and segs[-1][1] == hi
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    ops = tracing.ops_by_span([(s, (e - s) * 1e-6) for s, e in device], spans, lo, hi)
    assert {k: v[0] for k, v in ops.items()} == {"facade.track": 2, "lm.round": 1, "step.lm": 1, "step.collect": 1}
    assert sum(v[1] for v in ops.values()) == pytest.approx(51e-6)  # every op whole
    assert tracing.top(idle, 2) == [["step.lm", 33], ["facade.track", 20]]


def test_facade_reports_local_ba_time_not_the_frame_holding_it(monkeypatch):
    system = VOSystem(tum3_config().replace(camera=half_camera()), "cpu")
    tr = system.tracker

    def run_local_ba():
        time.sleep(0.02)
        tr.mapper.n_ba_runs += 1
        return True

    def track_rgbd(gray, depth, T_cw_init=None):
        with tracing.facade():
            time.sleep(0.2)  # the rest of the frame
            tr._local_ba()

    monkeypatch.setattr(tr.mapper, "run_local_ba", run_local_ba)
    monkeypatch.setattr(tr, "track_rgbd", track_rgbd)
    for i in range(2):
        system.track_rgbd(None, None, i / 30)
    rep = system.extract_times()
    ba_ms = float(rep.split("mean local BA time: ")[1].split(" ms")[0])
    assert 20 <= ba_ms < 100, rep
    assert "over 2 runs" in rep
    assert system.times.n_frames == 2 and system.times.track_total >= 0.4


def test_the_cli_profile_carries_the_spans(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tracing.enable()
        with tracing.span("facade.track", seq=0, frame=7):
            with torch.profiler.record_function("marker"):
                time.sleep(0.001)
        tracing.disable()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    cli._merge_spans(path, tracing.drain())
    events = json.load(open(path))["traceEvents"]
    (span,) = [e for e in events if e.get("cat") == "span"]
    (mark,) = [e for e in events if e.get("name") == "marker"]
    assert span["name"] == "facade.track" and span["args"]["frame"] == 7
    assert abs(span["ts"] - mark["ts"]) < 1000  # microseconds
