"""Readings that the limits of `correct` are set from (not run by the
benchmark's runs):

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 [--fault NAME]

For each of `--seeds`, a run of the cell as the benchmark makes it with a
window of `--seconds` (0 by default: the warm-up and one knee or step) and
the window's first knee judged, printing the numbers compared; with
`--fault`, the same with that fault of the driver's `FAULTS` planted under
the timed path. For each of `--control-seeds`, the same numbers with the
reference one precision below the configuration's in the program's place
(the driver's `control`). One JSON line each, then the largest of each
number over the program's seeds and the smallest over the control's. Run
on the card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("USE_FLAX", "0")
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from portbench import harness  # noqa: E402


def _ints(text):
    return [int(v) for v in text.split(",") if v]


def main(argv=None, device=None, config=None, traffic=None) -> dict:
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    cell = harness.make_cell(bench, args.workload, 0, args.seconds, False, T_START)
    cell.config = json.loads(json.dumps(config or cell.config))
    corr = cell.config["correctness"]
    if "check_knees" in corr:
        corr["check_knees"] = corr["check_from_first"] = 1
    cell.traffic = traffic or cell.traffic
    cell.device = device or harness.require_cards(cell.chips)
    mod = harness.driver(cell.config)
    fault = mod.FAULTS[args.fault] if args.fault else None
    side = f"fault {args.fault}" if args.fault else "program"
    prog, ctrl = {}, {}
    for seed in args.seeds:
        cell.seed, cell.t_start = seed, time.perf_counter()
        run = mod.run(cell, fault=fault)
        vals = {name: value for name, value, _ in run.checks}
        vals.update(run.details.get("readings", {}))
        print(json.dumps({"side": side, "seed": seed, "numbers": vals}), flush=True)
        for k, v in vals.items():
            prog[k] = max(prog.get(k, float("-inf")), v)
    for seed in args.control_seeds:
        cell.seed = seed
        try:
            vals = mod.control(cell)
        except Exception as e:  # noqa: BLE001 — a control that crashes has failed
            print(json.dumps({"side": "control", "seed": seed, "crashed": repr(e)}), flush=True)
            continue
        print(json.dumps({"side": "control", "seed": seed, "numbers": vals}), flush=True)
        for k, v in vals.items():
            ctrl[k] = min(ctrl.get(k, float("inf")), v)
    summary = {"program_max": prog, "control_min": ctrl}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
