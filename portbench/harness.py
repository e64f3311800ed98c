"""The benchmark's frame: it finds a cell's configuration, traffic and
metrics by the names in `BENCHMARK.json`, checks for the cards, hands the
cell to its configuration's driver (`portbench/drivers/<driver>.py`),
reduces the profiler's trace, reads each metric through its own reader
(`portbench/metrics/<metric>.py`), and prints the result line.

A driver's `run(cell)` returns a `Run`: the metric context its readers
read, the numbers compared for `correct` with their limits, and the counts
of work attempted and failed. Nothing here knows a configuration.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "oai_analysis_2_tpu")


class NoResult(RuntimeError):
    """A run that must end without a result line."""


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    end_to_end: List[dict]
    per_layer: List[dict]
    t_start: float  # perf_counter at process start
    device: object = None  # torch.device


@dataclasses.dataclass
class Run:
    metrics: dict  # the context the metric readers read
    checks: List[Tuple[str, float, float]]  # (name, value, limit): value <= limit
    attempted: int
    failed: int
    memory_peak_bytes: int
    details: dict = dataclasses.field(default_factory=dict)


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def make_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, t_start: float,
              root: Path = ROOT) -> Cell:
    """The cell called `name`, with its configuration and traffic files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise NoResult(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name=name, config_name=w["config"], config=config, traffic_name=w["traffic"], traffic=traffic,
                chips=int(w["chips"]), seed=int(seed), seconds=float(seconds), trace=bool(trace),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)], t_start=t_start)


def require_cards(n: int):
    """The card as a torch.device; raises NoResult without `n` cards."""
    import torch

    if not torch.cuda.is_available():
        raise NoResult("torch.cuda.is_available() is false: the benchmark measures the card and has no fallback")
    if torch.cuda.device_count() < n:
        raise NoResult(f"the cell needs {n} cards, torch sees {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def driver(config: dict):
    return importlib.import_module(f"portbench.drivers.{config['driver']}")


def _load_reader(name: str) -> Callable:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], ctx: dict) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader finds a number."""
    out = {}
    for m in metrics:
        value = _load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# The profiler's trace
# ---------------------------------------------------------------------------


class Trace:
    """torch.profiler over a stretch of the window. `reduce()` gives the
    device activities (kernels, copies, sets) as (name, start us, end us),
    their busy seconds (the union of their intervals), the traced window's
    seconds, device seconds by kernel name, and the longest idle gaps, each
    labelled "<layer>: <op>": the driver's `layer:` span around the gap's
    middle and the innermost other host span open where the gap starts."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.t0 = self.t1 = None

    def __enter__(self):
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        return False

    def _events(self):
        """(device activities, host spans) as (name, start us, end us)."""
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA and e.name.startswith("layer:"):
                continue  # the driver's spans, which the profiler mirrors on the card's timeline
            if e.device_type == DeviceType.CUDA:
                dev.append((e.name, float(tr.start), float(tr.end)))
            elif e.device_type == DeviceType.CPU:
                host.append((e.name, float(tr.start), float(tr.end)))
        if not dev:  # a torch that keeps device activities out of events()
            for e in self.prof.profiler.kineto_results.events():
                if e.device_type() == DeviceType.CUDA and not e.name().startswith("layer:"):
                    s = e.start_ns() / 1e3
                    dev.append((e.name(), s, s + e.duration_ns() / 1e3))
        return dev, host

    def reduce(self) -> dict:
        dev, host = self._events()
        window_s = self.t1 - self.t0
        by_name: Dict[str, float] = {}
        for name, s, e in dev:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        ivs = sorted((s, e) for _, s, e in dev)
        busy = 0.0
        gaps = []
        cur_s = cur_e = None
        for s, e in ivs:
            if cur_e is None:
                cur_s, cur_e = s, e
            elif s > cur_e:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, cur_e))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        gaps.sort(reverse=True)
        labelled = []
        layers = [(s, e, name[len("layer:"):]) for name, s, e in host if name.startswith("layer:")]
        for length, at in gaps[:10]:
            mid = at + length / 2
            inner = [(s, name) for name, s, e in host if s <= at < e and not name.startswith("layer:")]
            layer = [(s, name) for s, e, name in layers if s <= mid < e]
            labelled.append([f"{max(layer)[1] if layer else 'between layers'}: "
                             f"{max(inner)[1] if inner else 'host code without a span'}", length * 1e-6])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"kernels": by_name, "busy_s": busy * 1e-6, "window_s": window_s,
                "device_ops": [[k, v] for k, v in top], "idle_gaps": labelled,
                "n_device_events": len(dev)}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def _checks_text(checks) -> List[str]:
    return [f"check {name}: {value!r} (limit {limit!r}) {'ok' if value <= limit else 'FAILED'}"
            for name, value, limit in checks]


def run_cell(cell: Cell, fault=None) -> dict:
    """Drive the cell, read its metrics and build the result line. `fault`
    (tests only) is handed to the driver, which breaks the timed path with
    it."""
    import torch

    mod = driver(cell.config)
    run = mod.run(cell) if fault is None else mod.run(cell, fault=fault)
    bad = forbidden_modules()
    if bad:
        raise NoResult(f"modules of JAX or the JAX package were loaded in the measuring process: {bad}")
    metrics = read_metrics(cell.per_layer if cell.trace else cell.end_to_end, run.metrics)
    correct = bool(run.checks) and all(v <= lim for _, v, lim in run.checks) and run.failed == 0
    on_card = cell.device is not None and cell.device.type == "cuda"
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(cell.device) if on_card else "cpu", "count": cell.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": correct, "attempted": int(run.attempted), "failed": int(run.failed),
            "metrics": metrics, "device": device}
    tr = run.metrics.get("trace")
    if cell.trace and tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in run.checks}
    return line


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = load_benchmark()
        cell = make_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), t_start)
        from portbench import roofline

        cell.device = require_cards(cell.chips)
        print(f"card: {roofline.card_line()}", file=sys.stderr, flush=True)
        line = run_cell(cell)
    except NoResult as e:
        print(f"portbench: no result: {e}", file=sys.stderr, flush=True)
        return 2
    for text in _checks_text([(k, v["value"], v["limit"]) for k, v in line["checks"].items()]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
