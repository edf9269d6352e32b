"""The readers of the program's spans and host-sync counter, and the
slice's breakdown by span, on made-up recordings."""
import json
import time

import pytest

from hfvo_bench import run, spans
from hfvo_bench.run import Context

from .conftest import ROOT

tracing = pytest.importorskip("hfvo_tpu_torch.tracing")


def _reader(name):
    return run.load_module(ROOT / "hfvo_bench" / "metrics" / f"{name}.py", f"t_{name}")


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _slice(n_calls, syncs_each):
    """n_calls facade calls recorded as a traced slice, then two calls
    after it."""
    tracing.enable()
    for i in range(n_calls):
        with tracing.span("facade.track", seq=0, frame=i):
            with tracing.span("upload"):
                tracing.count("host_sync", syncs_each)
    tracing.count("host_sync", 5)  # outside any call: not a frame's
    tracing.disable()
    for _ in range(2):
        with tracing.span("step.lm"):
            time.sleep(0.002)
        with tracing.span("step.prepare"):
            time.sleep(0.001)
        with tracing.span("step.collect"):
            time.sleep(0.002)
            with tracing.span("step.split"):
                time.sleep(0.001)


def test_span_readers():
    _slice(3, 4)
    ctx = Context(trace=dict(frames=3, events=[]))
    assert _reader("host_syncs_per_frame").read(ctx) == pytest.approx(4.0)
    assert 2.0 <= _reader("lm_ms").read(ctx) < 20.0
    assert 1.0 <= _reader("step_prepare_ms").read(ctx) < 20.0
    wait = _reader("collect_wait_ms").read(ctx)
    assert 2.0 <= wait < 20.0
    s, n = tracing.totals(since_stop=True)["step.collect"]
    assert wait < 1e3 * s / n  # the split is left out


def test_span_readers_read_nothing_without_a_recording():
    ctx = Context(trace=dict(frames=3, events=[]))
    for name in ("host_syncs_per_frame", "lm_ms", "step_prepare_ms", "collect_wait_ms"):
        assert _reader(name).read(Context(trace=None)) is None
    assert _reader("host_syncs_per_frame").read(ctx) is None  # nothing was recorded
    tracing.enable()  # the slice has not ended
    assert _reader("lm_ms").read(ctx) is None


def test_breakdown_places_the_slice_on_the_spans():
    tracing.enable()
    for i in range(2):
        with tracing.span("facade.track", seq=0, frame=i):
            with tracing.span("upload"):
                time.sleep(0.001)
            with tracing.span("step.lm"):
                tracing.count("host_sync")
                time.sleep(0.002)
        time.sleep(0.001)
    tracing.disable()
    rec = tracing.drain()
    up = [s for s in rec.spans if s.name == "upload"]
    lm = [s for s in rec.spans if s.name == "step.lm"]
    # A pageable copy starting inside each upload; a kernel in the first LM.
    events = [((u.start_ns + 100_000) / 1e3, (u.start_ns + 200_000) / 1e3, "Memcpy HtoD (Pageable -> Device)", 0)
              for u in up]
    events.append(((lm[0].start_ns + 10_000) / 1e3, (lm[0].start_ns + 20_000) / 1e3, "kernel", 0))
    b = spans.breakdown(dict(events=events), rec)
    assert b["clock"]["uploads"] == b["clock"]["holding_a_pageable_copy"] == 2
    assert b["idle_by_span_sum_s"] == pytest.approx(b["idle_s"], rel=1e-6)
    assert {r[0] for r in b["ops_by_span"]} == {"upload", "step.lm"}
    assert b["host_syncs_one_frame"]["total"] == 1
    assert b["host_syncs_one_frame"]["by_span"] == {"step.lm": 1}
    assert 0 < b["outside_and_facade_share"] < 1


def test_breakdown_moves_a_drifting_device_clock_onto_the_host():
    tracing.enable()
    for i in range(40):
        with tracing.span("facade.track", seq=0, frame=i):
            with tracing.span("upload"):
                time.sleep(0.0003)
        time.sleep(0.0002)
    tracing.disable()
    rec = tracing.drain()
    t_first = min(s.start_ns for s in rec.spans)
    runtime, events = [], []
    for i, u in enumerate(s for s in rec.spans if s.name == "upload"):
        for j in range(30):  # the copy, then kernels queued by the same call
            corr = 100 * i + j
            call = u.start_ns + 20_000
            start = call + 3_000 - 0.05 * (call - t_first)  # a device clock falling behind
            runtime.append((call, corr, "cudaMemcpyAsync" if j == 0 else "cudaLaunchKernel"))
            name = "Memcpy HtoD (Pageable -> Device)" if j == 0 else "kernel"
            events.append((start / 1e3, (start + 1_000) / 1e3, name, corr))
    raw = spans.breakdown(dict(events=events), rec)
    fixed = spans.breakdown(dict(events=events), rec, runtime=runtime)
    json.dumps(fixed, allow_nan=False)  # as the tool prints it
    assert raw["clock"]["holding_a_pageable_copy"] < 40
    assert fixed["clock"]["holding_a_pageable_copy"] == fixed["clock"]["holding_its_runtime_call"] == 40
    assert fixed["clock"]["device_lag_us_first_last"][1] < -100
    assert [r[0] for r in fixed["ops_by_span"]] == ["upload"]
