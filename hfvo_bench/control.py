"""The readings the limits of `limits/<cell>.json` are set from.

    python hfvo_bench/control.py --workload <cell> --seeds 11,12,13 --seconds 12 [--out file]

For each seed, one run of the cell in this process (set-up, a window of
`--seconds`, the check), then one JSON line: the program's numbers (the
lower readings); the control's, the reference one precision below the
configuration's float32 (TF32) put in the program's place (the upper
readings); and the BA numbers of a solve that returns its input state
unchanged (the program's final gate at the captured problem's state: the
no-op fault). The benchmark's own runs do not run this. It needs the card,
as run.py does.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hfvo_bench import check, run  # noqa: E402


def _num(v):
    return v if v is None or math.isfinite(v) else str(v)


def noop_ba(ba, workload: str) -> dict:
    """The BA numbers of the no-op fault on the captured problem."""
    if ba is None:
        return {}
    from hfvo_tpu_torch.solve.ba import final_gate

    found = run.discover(run.ROOT, workload, 0)
    cam = found["config"]["vo_config"]["camera"]
    p = ba["prob"]
    return check.ref_ba.judge(p, final_gate(p, p.kf_T_cw, p.pt_X, found["cfg"].camera), cam)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    lines = []
    for seed in (int(s) for s in a.seeds.split(",")):
        args = run.parse(["--workload", a.workload, "--seed", str(seed), "--seconds", str(a.seconds)])
        try:
            result, compared, ctrl = run.run_cell(args, control=True)
        except run.RunError as e:
            print(f"hfvo_bench: {e}", file=sys.stderr)
            return e.code
        line = dict(workload=a.workload, seed=seed, correct=result["correct"], samples=result["samples"],
                    program={n: _num(v) for n, v, _ in compared},
                    control={n: _num(v) for n, v in ctrl["numbers"].items()},
                    noop_ba={n: _num(v) for n, v in noop_ba(ctrl["ba"], args.workload).items()},
                    metrics=result["metrics"])
        print(json.dumps(line), flush=True)
        lines.append(line)
    if a.out:
        Path(a.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    bad = run.forbidden_loaded()
    if bad:
        print(f"hfvo_bench: loaded {', '.join(bad)}", file=sys.stderr)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
