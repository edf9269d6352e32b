"""Benchmark of the port `hfvo_tpu_torch` on one NVIDIA GPU.

    python hfvo_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process: it checks for the card, renders the cell's traffic
from the seed, builds the system and warms it up (set-up), hands it frames
for `--seconds` (the window), judges what the window returned against the
plain reference, and prints one JSON line last. Everything a cell needs is
found by name: the cell in BENCHMARK.json, its configuration file, its
traffic mix `traffic/<name>.json`, its driver `drivers/<driver>.py`, its
limits `limits/<cell>.json` and each metric's reader `metrics/<name>.py`.
With `--trace 0` the line holds the cell's end-to-end metrics; with
`--trace 1` its per-layer metrics, read from a profiled slice at the start
of the window and from the program's stage timers after it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Build and kernel caches at fixed paths inside the checkout (the port
# itself builds its CUDA libraries into build/hfvo_tpu_torch/ there).
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
# One host thread for torch's and the BLAS libraries' CPU work: the port's
# host path is serial Python on small arrays, and a pool of threads only
# adds contention with the host's other tenants to the spread of a run.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from hfvo_bench import check, gen, trace  # noqa: E402
from hfvo_bench.capture import Capture  # noqa: E402

T_IMPORTED = time.perf_counter()

# The traced slice: the profiler runs from the window's start to the first
# call boundary after this many seconds (a whole window at ~19,000 device
# ops a frame would be millions of events).
TRACE_SLICE_S = 4.0
# Top-level module names the run's process may not hold once the window
# has closed: JAX and the JAX package (compared whole, so `hfvo_tpu_torch`
# is not `hfvo_tpu`).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "hfvo_tpu")


class RunError(Exception):
    """A run that cannot give a result (exit code `code`)."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


@dataclasses.dataclass
class Context:
    """What the metric readers read (metrics/<name>.py)."""

    setup_s: float = 0.0
    window_s: float = 0.0
    n_returned: int = 0
    host: dict = dataclasses.field(default_factory=dict)  # after the traced slice
    trace: Optional[dict] = None


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise RunError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def vo_config(d: dict):
    """The port's VOConfig from a configuration file's `vo_config`."""
    from hfvo_tpu_torch import config as C
    from hfvo_tpu_torch.geometry.camera import Intrinsics

    groups = dict(camera=Intrinsics, orb=C.OrbConfig, lines=C.LineConfig, planes=C.PlaneConfig,
                  manhattan=C.ManhattanConfig, tracking=C.TrackingConfig, cap=C.Capacities)
    kw = {k: (groups[k](**v) if k in groups else v) for k, v in d.items()}
    return C.VOConfig(**kw)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def stage_totals(trackers) -> dict:
    tot = {}
    for tr in trackers:
        for k, (s, n) in tr.stage_times.items():
            a = tot.setdefault(k, [0.0, 0])
            a[0] += s
            a[1] += n
    return tot


def stage_delta(after: dict, before: dict) -> dict:
    return {k: (v[0] - before.get(k, (0.0, 0))[0], v[1] - before.get(k, (0.0, 0))[1]) for k, v in after.items()}


def warm_keyframe_path(cfg, cam, bench_dir: Path, warm: dict, seed: int, device) -> None:
    """Run a throwaway tracker over a few frames of a mix that makes a
    keyframe on most frames, until one local BA has run: the keyframe path
    (triangulation, fusion, BA's solvers, loop detection) then has launched
    every kernel it uses before the window."""
    from hfvo_tpu_torch.tracking.tracker import Tracker

    params = gen.load_params(bench_dir, warm["keyframe_path_traffic"])
    tr = gen.build(warm["keyframe_path_traffic"], params, cam, cfg.fps, 1, seed, device,
                   n_render=warm["keyframe_path_max_frames"])
    t = Tracker(cfg, device)
    for i in range(tr.period):
        t.track_rgbd(tr.gray[i], tr.depth[i])
        if t.mapper.n_ba_runs:
            break
    del t, tr


def discover(root: Path, workload: str, trace: int) -> dict:
    """Everything a cell needs, found by name from BENCHMARK.json under
    `root`: its cell and configuration entries, the configuration file and
    the port's VOConfig from it, its traffic mix, limits, driver and the
    readers of the metrics it reports with `--trace trace`."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    bench_dir = root / spec["paths"][0]
    try:
        import hfvo_tpu_torch  # noqa: F401
    except ImportError as e:
        raise RunError(f"the program is not in this checkout: {e}", 4)
    cfile = json.loads((root / conf["file"]).read_text())
    metric_specs = spec["per_layer"] if trace else spec["end_to_end"]
    metric_specs = [m for m in metric_specs if m.get("workloads") is None or cell["name"] in m["workloads"]]
    return dict(
        spec=spec, cell=cell, bench_dir=bench_dir, config=cfile, cfg=vo_config(cfile["vo_config"]),
        traffic=gen.load_params(bench_dir, cell["traffic"]),
        limits=json.loads((bench_dir / "limits" / f"{cell['name']}.json").read_text())["limits"],
        driver=load_module(bench_dir / "drivers" / f"{cfile['driver']}.py", f"hfvo_bench_driver_{cfile['driver']}"),
        metrics=metric_specs,
        readers={m["name"]: load_module(bench_dir / "metrics" / f"{m['name']}.py", f"hfvo_bench_metric_{m['name']}")
                 for m in metric_specs},
    )


def run_cell(args, root: Path = ROOT, device=None, control: bool = False):
    """One run; returns (result dict, [(number, value, limit)], None or,
    with `control`, the control's numbers and the captured BA solve).
    `device` None means the card, checked for."""
    found = discover(root, args.workload, args.trace)
    cell, cfile, cfg, params, limits = found["cell"], found["config"], found["cfg"], found["traffic"], found["limits"]
    bench_dir, driver_mod, readers, metric_specs = found["bench_dir"], found["driver"], found["readers"], found["metrics"]
    if device is None:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark measures the card and never the CPU", 3)
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{torch.cuda.device_count()} CUDA devices, the cell needs {cell['chips']}", 3)
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    cam = cfile["vo_config"]["camera"]
    system = cfile["system"]
    n_seq = system["n_seq"]

    phases = {"imports": T_IMPORTED - T_START, "discover": time.perf_counter() - T_IMPORTED}

    def phase(name):
        if on_card:
            torch.cuda.synchronize()
        phases[name] = time.perf_counter() - T_START - sum(phases.values())

    if on_card:
        torch.cuda.init()
        torch.zeros(1, device=device)
    phase("cuda_init")
    # ---- set-up: inputs from the seed, the system, its warm-up ----
    traffic = gen.build(cell["traffic"], params, cam, cfg.fps, n_seq, args.seed, device)
    samples_rng = np.random.default_rng(np.random.SeedSequence([int(args.seed), 1]))
    smp = params["samples"]
    sample_calls = set(int(c) for c in samples_rng.choice(smp["kernel_frame_pool"], smp["kernel_frames"],
                                                         replace=False))
    cap = Capture()
    cap.ba_target = int(samples_rng.integers(0, smp["ba_run_pool"]))
    cap.install()
    phase("render")
    drv = driver_mod.Driver(cfg, system, device)
    drv.build_kernels(traffic.gray[0], traffic.depth[0])
    phase("system_and_kernels")
    warm_keyframe_path(cfg, cam, bench_dir, cfile["warmup"], args.seed, device)
    phase("keyframe_path_warmup")
    nxt = 0  # next frame index of every sequence

    def frames_at(i):
        return [(traffic.gray[traffic.frame(s, i)], traffic.depth[traffic.frame(s, i)], traffic.timestamp(i))
                for s in range(n_seq)]

    for _ in range(params["warmup_frames"]):
        drv.submit(frames_at(nxt))
        nxt += 1
    drv.drain()
    drv.resolve_s.clear()
    phase("warmup_frames")
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # ---- the window ----
    pending = [deque() for _ in range(n_seq)]
    answers, latencies = [], []
    host = dict(latencies_ms=[], resolve_s=[], frames=0)
    n_handed = 0
    prof = None
    slice_info = None
    stages0 = stage_totals(drv.trackers)
    ba0 = sum(t.mapper.n_ba_runs for t in drv.trackers)
    cap.ba_armed = True
    if args.trace:
        # Device activity only: recording every host operator as well slows
        # the host ~10x and would make the slice's idle share the profiler's.
        # Started before the window: starting CUPTI takes seconds.
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        cap.record_launches = True
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    call = 0
    in_slice = bool(args.trace)
    slice_frames = 0

    extra = [0]  # poses back for no frame handed in

    def settle(res, t_back):
        for s, r in res:
            if not pending[s]:
                extra[0] += 1
                continue
            i, t_in = pending[s].popleft()
            lat = (t_back - t_in) * 1e3
            answers.append((s, i, r))
            latencies.append(lat)
            if not in_slice:
                host["latencies_ms"].append(lat)
                host["frames"] += 1

    while time.perf_counter() - t0 < args.seconds:
        frames = frames_at(nxt)
        if call in sample_calls:
            cap.begin_sample([traffic.frame(s, nxt) for s in range(n_seq)])
        t_in = time.perf_counter()
        for s in range(n_seq):
            pending[s].append((nxt, t_in))
        n_handed += n_seq
        nr = len(drv.resolve_s)
        res = drv.submit(frames)
        t_back = time.perf_counter()
        cap.end_sample()
        settle(res, t_back)
        if not in_slice:
            host["resolve_s"].extend(drv.resolve_s[nr:])
        else:
            slice_frames += n_seq
        nxt += 1
        call += 1
        if in_slice and t_back - t0 >= TRACE_SLICE_S:
            if on_card:
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            slice_info = dict(window_s=time.perf_counter() - t0, frames=slice_frames)
            cap.record_launches = False
            in_slice = False
            stages_slice = stage_totals(drv.trackers)
            ba_slice = sum(t.mapper.n_ba_runs for t in drv.trackers)
    nr = len(drv.resolve_s)
    res = drv.drain()
    t_end = time.perf_counter()
    settle(res, t_end)
    host["resolve_s"].extend(drv.resolve_s[nr:])
    if in_slice:  # the window ended inside the slice
        if on_card:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        slice_info = dict(window_s=time.perf_counter() - t0, frames=slice_frames)
        cap.record_launches = False
    if args.trace and slice_info is not None and host["frames"] > 0:
        host["stages"] = stage_delta(stage_totals(drv.trackers), stages_slice)
        host["ba_runs"] = sum(t.mapper.n_ba_runs for t in drv.trackers) - ba_slice
    else:
        host["stages"] = stage_delta(stage_totals(drv.trackers), stages0)
        host["ba_runs"] = sum(t.mapper.n_ba_runs for t in drv.trackers) - ba0
        host["latencies_ms"] = list(latencies)
        host["frames"] = len(latencies)
    cap.ba_armed = False
    window_s = t_end - t0
    unreturned = sum(len(p) for p in pending)
    n_failed = unreturned + sum(1 for _, _, r in answers if r.state.name != "OK")

    # ---- after the window: memory, the trace, then the check ----
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    ctx = Context(setup_s=setup_s, window_s=window_s, n_returned=len(answers), host=host)
    breakdown = None
    if args.trace:
        evs = trace.device_events(prof)
        ctx.trace = dict(events=evs, window_s=slice_info["window_s"], frames=slice_info["frames"],
                         busy_s=trace.busy_ms(trace.device_spans(evs)) / 1e3, fast_launches=cap.fast_launches,
                         hough_launches=[(tuple(m.shape), voting_px(m, th)) for m, th in cap.hough_launches])
        cap.hough_launches = []
        breakdown = {"device_ops": trace.top_ops(evs), "idle_gaps": trace.idle_gaps(evs)}
        del prof
    metrics = {}
    for m in metric_specs:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    del drv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    nums = check.numbers(answers, unreturned + extra[0], cap.samples, cap.ba, traffic, cfg, cam, n_seq)
    ctrl = dict(numbers=check.numbers(answers, unreturned + extra[0], cap.samples, cap.ba, traffic, cfg, cam, n_seq,
                                      tf32=True), ba=cap.ba) if control else None
    compared = []
    for name, lim in limits.items():
        v = nums.get(name)
        compared.append((name, v, lim))
    # The BA numbers are not read where no local BA ran in the window.
    correct = all((v is None and name in check.BA_NUMBERS) or (v is not None and v <= lim)
                  for name, v, lim in compared)
    device_info = dict(platform="gpu" if on_card else "cpu",
                       kind=torch.cuda.get_device_name(device) if on_card else "cpu",
                       count=1, memory_peak_bytes=int(peak),
                       power_limit=power_limit() if on_card else "none")
    if ctx.trace is not None:
        device_info["busy_s"] = ctx.trace["busy_s"]
        device_info["window_s"] = ctx.trace["window_s"]
    result = dict(correct=bool(correct), attempted=n_handed, failed=n_failed, metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["samples"] = dict(latencies=len(latencies), ba_runs=int(host["ba_runs"]),
                             ba_checked=cap.ba is not None, kernel_frames=len(cap.samples), window_calls=call,
                             setup_phases_s=phases)
    result["checks"] = {n: {"value": _json_num(v), "limit": lim} for n, v, lim in compared}
    return result, compared, ctrl


def voting_px(mag: torch.Tensor, mag_th: float) -> int:
    """Pixels of whole 64x64 tiles above the Hough threshold."""
    h, w = mag.shape[-2:]
    return int((mag[..., : h // 64 * 64, : w // 64 * 64] > mag_th).sum())


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if a.seed < 0:
        ap.error("--seed must be a non-negative whole number")
    return a


def fmt(v) -> str:
    return "not read" if v is None else repr(float(v))


def main(argv=None) -> int:
    args = parse(argv)
    try:
        result, compared, _ = run_cell(args)
    except RunError as e:
        print(f"hfvo_bench: {e}", file=sys.stderr)
        return e.code
    bad = forbidden_loaded()
    if bad:
        print(f"hfvo_bench: the run loaded {', '.join(bad)}; the benchmark may not", file=sys.stderr)
        return 5
    s = result["samples"]
    print(f"samples: {s['latencies']} frame latencies, {s['window_calls']} calls, {s['ba_runs']} local BA runs "
          f"(one checked: {s['ba_checked']}), {s['kernel_frames']} sampled kernel frames", file=sys.stderr)
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in s["setup_phases_s"].items()), file=sys.stderr)
    print(f"card: {result['device']['kind']} ({result['device']['power_limit']})", file=sys.stderr)
    for name, v, lim in compared:
        print(f"check {name}: {fmt(v)} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False))
    return 0


def _json_num(v):
    return v if v is None or math.isfinite(v) else str(v)


if __name__ == "__main__":
    sys.exit(main())
