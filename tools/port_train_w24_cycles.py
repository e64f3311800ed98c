"""The w24 GradICON recipe of `tools/train_w24_cycles.sh` through the port,
from scratch: three warm-restart cycles of the port's
`examples.train_gradicon_synthetic` in one process, then the known-field
validator with the trained weights and with the shipped ones.

    python3 tools/port_train_w24_cycles.py [--out PATH] [--steps N] [--pool N]

The recipe: GradICON width 24 on the 48x96x96 grid, bf16, batch 2, sup 1.0
/ sim 0.1, heads initialised to zero, 600 steps a cycle at peak lr 3e-4,
then 1.5e-4, then 8e-5, a pool of 96 phantoms. Each cycle gets the `.sh`'s
environment (`GRADICON_WIDTH`, `GRADICON_SUP_W`, `GRADICON_SIM_W`,
`GRADICON_LR`; from the second cycle on `GRADICON_RESUME=<out>` and
`GRADICON_BEST=<the .best sidecar's text>`), every other `GRADICON_*`
variable is unset while it runs, and the caller's environment is restored
afterwards. `--steps` and `--pool` cut the recipe (the defaults are the
recipe's). The checkpoint and its sidecar go to `--out` (default the
git-ignored `build/gradicon_w24_port/gradicon.npz`; any earlier file
there is removed first, and the shipped weights file is refused), the
report to `report.json` beside it.

Per cycle it prints the eval curve, the best so far and whether a
checkpoint was written, the median and p90 seconds a step over the whole
cycle and over its first and last 100 steps, the wall time, the peak
device memory and the conv launches a step by route and direction. Its
last line is a JSON summary: the best eval over the cycles, the four
validator runs (`--network 0` and `--network 20`, trained and shipped:
mean, median and p95 field error in mm, inverse consistency, folds) with
the trained-minus-shipped gaps, and the card's name and power limit.

It exits non-zero on a non-finite loss, launches a step other than the
trainer's expectation (the bf16 stage convs of 2 pairs x 2 directions x 3
stages, 12 forwards and backwards a step, no enc0a data gradient in stage
0, no wmma launch; 30 f32 launches an eval), a `.best` that rises between
cycles, a cycle that does not start from the checkpoint on disk (the
first: from zero heads), a checkpoint that does not reload bit-equal to
the weights it was written from, or a checkpoint whose eval does not give
its sidecar's number. The accuracy targets are reported, not gated.

Uncut on one H100 80GB HBM3 at 700 W it took 0.28-0.29 s a step (the
median of each cycle), 8.9 minutes for the cycles and the validators, and
41 s of kernel build before them. It needs an NVIDIA card; `run_cycles(..., device="cpu")` runs the same path
on the CPU at a small width and grid (the tests do).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

LRS = (3e-4, 1.5e-4, 8e-5)
DEFAULT_OUT = ROOT / "build" / "gradicon_w24_port" / "gradicon.npz"
DRIFT_WINDOW = 100  # steps at each end of a cycle whose step times are compared
DRIFT_LIMIT = 0.10  # a median that moves by more than this share "drifts"
EVAL_F32_LAUNCHES = 30  # one f32 direction: 3 stages x 10 convs
RELOAD_EVAL_TOL = 1e-5  # the sidecar holds the eval to 6 decimals
TARGETS = {"best_eval_vox": 0.70, "validator_gap_mm": 0.125}


class RecipeFault(AssertionError):
    """A gate of the recipe failed: the run is not a reproduction."""


def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _flat(params_list) -> dict:
    from oai_analysis_2_tpu_torch.utils.checkpoint import flatten_tree

    return flatten_tree({f"stage{k}": p for k, p in enumerate(params_list)})


def _same_params(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)


def _step_stats(step_s) -> dict:
    s = np.asarray(step_s, np.float64)
    n = max(1, min(DRIFT_WINDOW, len(s) // 2))
    first, last = s[:n], s[-n:]
    drift = float(np.median(last) / np.median(first))
    return {"median_s": float(np.median(s)), "p90_s": float(np.percentile(s, 90)),
            "first_steps": n, "first_median_s": float(np.median(first)), "first_p90_s": float(np.percentile(first, 90)),
            "last_median_s": float(np.median(last)), "last_p90_s": float(np.percentile(last, 90)),
            "drift_last_over_first": drift, "drifts": bool(abs(drift - 1.0) > DRIFT_LIMIT)}


def _recipe_env(width, grid, lr, pool, out, best_text) -> dict:
    env = {"GRADICON_WIDTH": str(width), "GRADICON_GRID": ",".join(map(str, grid)), "GRADICON_SUP_W": "1.0",
           "GRADICON_SIM_W": "0.1", "GRADICON_LR": str(lr), "GRADICON_BEST": best_text}
    if pool is not None:
        env["GRADICON_POOL"] = str(int(pool))
    if best_text != "inf":  # the .sh resumes from the second cycle on
        env["GRADICON_RESUME"] = str(out)
    return env


def _expected_launches(cuda_conv, width, grid, dev, n_evals) -> dict:
    """Route counts a step (no f32) and f32 launches a cycle; on the CPU the
    wrappers launch nothing, so everything is 0."""
    import torch

    from oai_analysis_2_tpu_torch.models.gradicon import _stage_spec

    zeros = {k: 0 for k in chip_smoke.route_counts(cuda_conv) if not k.endswith("f32")}
    if dev.type != "cuda":
        return {"per_step": zeros, "f32": 0}
    convs = chip_smoke.unet_convs(_stage_spec(width), (1,) + tuple(grid), "")
    # 2 pairs x 2 directions x 3 stages; stage 0's input needs no gradient
    want = chip_smoke.expected_train_counts(cuda_conv, convs, torch.bfloat16, 12, 4)
    return {"per_step": {k: v for k, v in want.items() if not k.endswith("f32")},
            "f32": EVAL_F32_LAUNCHES * n_evals}


def _run_validators(out, counts, shipped, validate_shape, dev) -> dict:
    """`validate_registration --network N --weights W` for N in `counts`, on
    the trained weights and (with `shipped`) the shipped ones."""
    from oai_analysis_2_tpu_torch.examples import validate_registration
    from oai_analysis_2_tpu_torch.models.gradicon import default_gradicon_weights_path

    size = [str(v) for v in validate_shape] if validate_shape else []
    weights = {"trained": str(out)}
    if shipped:
        weights["shipped"] = str(default_gradicon_weights_path())
    keys = ("seconds", "mse_ratio", "err_mean_mm", "err_median_mm", "err_p95_mm", "ice_mean_vox", "ice_mean_mm",
            "fold_fraction_ab", "fold_fraction_ba")
    report = {}
    for which, path in weights.items():
        for n in counts:
            r = validate_registration.main(size + ["--network", str(n), "--weights", path], device=dev)
            values = {k: r[k] for k in keys}
            if not all(np.isfinite(v) for v in values.values()):
                raise RecipeFault(f"validate_registration --network {n} on the {which} weights: {values}")
            report[f"{which}_network{n}"] = values
    return report


def run_cycles(out_path, steps_per_cycle=600, lrs=LRS, batch=2, pool=None, device=None, *, width=24,
               grid=(48, 96, 96), validators=(0, 20), shipped=True, validate_shape=None) -> dict:
    """Run the recipe's cycles into `out_path` and then the validators; every
    gate of the module's docstring raises `RecipeFault`. Returns the report:
    `cycles` (one dict a cycle), `best_eval_vox`, `validators` and, with
    `shipped`, the trained-minus-shipped gaps and the targets.

    width, grid: the network and its grid (the recipe's by default; the CPU
    tests shrink them). validators: the `--network` fine-tuning counts to
    validate with; shipped: also validate the shipped weights;
    validate_shape: the validator's phantom and net grid (its default
    80x192x192 phantom when None)."""
    import torch

    from oai_analysis_2_tpu_torch.core.device import resolve_device, synchronize
    from oai_analysis_2_tpu_torch.examples import train_gradicon_synthetic as trainer
    from oai_analysis_2_tpu_torch.models.gradicon import (
        GradICON,
        GradICONConfig,
        default_gradicon_weights_path,
        load_gradicon_checkpoint,
    )
    from oai_analysis_2_tpu_torch.ops import cuda_conv

    dev = resolve_device(device)
    out = Path(out_path).resolve()
    if out == default_gradicon_weights_path().resolve():
        raise ValueError(f"{out} is the shipped weights file; train into another path")
    sidecar = out.parent / (out.name + ".best")
    for stale in (out, sidecar):
        stale.unlink(missing_ok=True)
    cfg = GradICONConfig(grid_shape=tuple(grid), stage_width=width)
    eval_err = trainer.make_eval(cfg, dev)
    reloaded = GradICON(cfg, device=dev)

    def check(what, summary, launches, before, best_before) -> dict:
        """One cycle's gates; returns its record. `before`: the checkpoint's
        params and digest before the cycle (None for the first)."""
        losses = np.asarray(summary["losses"], np.float64)
        if not np.isfinite(losses).all():
            raise RecipeFault(f"{what}: non-finite loss at steps {np.flatnonzero(~np.isfinite(losses)).tolist()}")
        n_steps, n_evals = len(losses), len(summary["eval"])
        want = _expected_launches(cuda_conv, width, grid, dev, n_evals)
        per_step = {k: v / n_steps for k, v in launches.items() if not k.endswith("f32")}
        if per_step != want["per_step"] or launches["fwd_f32"] != want["f32"] or launches["dgrad_f32"] != 0:
            raise RecipeFault(f"{what}: launches a step {per_step}, want {want['per_step']}; f32 "
                              f"{launches['fwd_f32']} forward (want {want['f32']}), "
                              f"{launches['dgrad_f32']} data gradients")
        # the hand-off: cycle 1 from zero heads, later cycles from the file on disk
        if before is None:
            heads = [v for k, v in _flat(summary["start_params"]).items() if "/head/" in k]
            if summary["resumed_from"] is not None or not heads or any(np.any(v != 0) for v in heads):
                raise RecipeFault(f"{what}: did not start from a fresh init with zero heads")
        elif summary["resumed_from"] != str(out) or not _same_params(summary["start_params"], before[0]):
            raise RecipeFault(f"{what}: did not start from the checkpoint on disk ({summary['resumed_from']})")
        if not sidecar.exists() or not out.exists():
            raise RecipeFault(f"{what}: no checkpoint or no .best sidecar after the cycle")
        best_after = float(sidecar.read_text())
        if best_after > best_before:
            raise RecipeFault(f"{what}: .best rose from {best_before} to {best_after}")
        written = summary["checkpoint"] is not None
        params, meta = load_gradicon_checkpoint(out)
        if written:
            if not _same_params(params, summary["checkpoint_params"]):
                raise RecipeFault(f"{what}: the checkpoint does not reload bit-equal to the weights it was "
                                  "written from")
            if sidecar.read_text() != f"{summary['best']:.6f}":
                raise RecipeFault(f"{what}: .best {sidecar.read_text()} against the cycle's best {summary['best']}")
        elif _digest(out) != before[1] or best_after != best_before:
            raise RecipeFault(f"{what}: no eval improved, yet the checkpoint or its sidecar changed")
        if meta != {"stage_width": width, "grid_shape": tuple(grid), "scales": cfg.scales}:
            raise RecipeFault(f"{what}: checkpoint metadata {meta}")
        reloaded.load_params(params)
        reload_eval = eval_err(reloaded)[0]
        if not abs(reload_eval - best_after) <= RELOAD_EVAL_TOL:
            raise RecipeFault(f"{what}: the checkpoint on disk evaluates to {reload_eval}, its sidecar says "
                              f"{best_after}")
        return {"eval": {int(k): list(v) for k, v in summary["eval"].items()},
                "best_after": best_after, "checkpoint_written": written, "reload_eval_vox": reload_eval,
                "resumed_from": summary["resumed_from"], "losses_first_last": [losses[0], losses[-1]],
                "launches_per_step": per_step, "eval_f32_launches": launches["fwd_f32"]}

    ambient = {k: v for k, v in os.environ.items() if k.startswith("GRADICON_")}
    cycles = []
    best_before = float("inf")
    try:
        for c, lr in enumerate(lrs):
            best_text = sidecar.read_text() if sidecar.exists() else "inf"  # the .sh's best()
            before = (load_gradicon_checkpoint(out)[0], _digest(out)) if c else None
            for k in [k for k in os.environ if k.startswith("GRADICON_")]:
                del os.environ[k]
            os.environ.update(_recipe_env(width, grid, lr, pool, out, best_text))
            cuda_conv.reset_launches()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            synchronize(dev)
            t0 = time.perf_counter()
            summary = trainer.main([str(steps_per_cycle), str(batch), str(out)], device=dev)
            synchronize(dev)
            wall = time.perf_counter() - t0
            launches = chip_smoke.route_counts(cuda_conv)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
            cycle = check(f"cycle {c + 1} (lr {lr})", summary, launches, before, best_before)
            cycle.update(cycle=c + 1, lr=lr)
            cycle.update(wall_s=wall, max_memory_allocated_gb=peak_gb, steps=steps_per_cycle, batch=batch,
                         step_s=_step_stats(summary["step_seconds"]))
            best_before = cycle["best_after"]
            cycles.append(cycle)
            print(_cycle_line(cycle), flush=True)
    finally:
        for k in [k for k in os.environ if k.startswith("GRADICON_")]:
            del os.environ[k]
        os.environ.update(ambient)
    report = {"cycles": cycles, "best_eval_vox": best_before, "checkpoint": str(out),
              "validators": _run_validators(out, validators, shipped, validate_shape, dev)}
    if shipped:
        v = report["validators"]
        report["gap_mm"] = {f"network{n}": v[f"trained_network{n}"]["err_mean_mm"]
                            - v[f"shipped_network{n}"]["err_mean_mm"] for n in validators}
        report["targets"] = dict(TARGETS, best_eval_met=best_before <= TARGETS["best_eval_vox"],
                                 validator_gaps_met=all(abs(g) <= TARGETS["validator_gap_mm"]
                                                        for g in report["gap_mm"].values()))
    return report


def _cycle_line(r) -> str:
    s = r["step_s"]
    curve = " ".join(f"{k}:{v[0]:.4f}" for k, v in r["eval"].items())
    mem = "n/a" if r["max_memory_allocated_gb"] is None else f"{r['max_memory_allocated_gb']:.3f} GB"
    routes = ", ".join(f"{k} {v:g}" for k, v in r["launches_per_step"].items() if v)
    return (f"cycle {r['cycle']} (lr {r['lr']}, {r['steps']} steps): eval {curve}; best {r['best_after']:.6f} "
            f"({'checkpoint written' if r['checkpoint_written'] else 'no checkpoint written'}); step median "
            f"{s['median_s']:.4f} s p90 {s['p90_s']:.4f} s, first {s['first_steps']} {s['first_median_s']:.4f} / "
            f"{s['first_p90_s']:.4f} s, last {s['last_median_s']:.4f} / {s['last_p90_s']:.4f} s "
            f"({'drifts' if s['drifts'] else 'no drift'}, x{s['drift_last_over_first']:.3f}); wall "
            f"{r['wall_s']:.1f} s; peak {mem}; launches a step: {routes or 'none'}; "
            f"f32 {r['eval_f32_launches']} in the evals")


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--steps", type=int, default=600, help="steps a cycle (the recipe's 600)")
    parser.add_argument("--pool", type=int, default=None, help="phantoms in the pool (the recipe's 96)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_train_w24_cycles: this script needs an NVIDIA card", file=sys.stderr)
        return 1
    from oai_analysis_2_tpu_torch.bench import card_line
    from oai_analysis_2_tpu_torch.ops import cuda_build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    try:
        report = run_cycles(args.out, steps_per_cycle=args.steps, pool=args.pool, device="cuda")
    except RecipeFault as e:
        print(f"port_train_w24_cycles: {e}", file=sys.stderr)
        return 1
    report["seconds"] = time.perf_counter() - t0
    report["card"] = card
    for name, v in report["validators"].items():
        print(f"validate_registration {name}: mean {v['err_mean_mm']:.4f} median {v['err_median_mm']:.4f} p95 "
              f"{v['err_p95_mm']:.4f} mm, inverse consistency {v['ice_mean_vox']:.4f} vox, folds "
              f"{v['fold_fraction_ab']:.6f} / {v['fold_fraction_ba']:.6f}, {v['seconds']:.3f} s", flush=True)
    Path(report["checkpoint"]).with_name("report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"best_eval_vox": report["best_eval_vox"], "validators": report["validators"],
                      "gap_mm": report["gap_mm"], "targets": report["targets"],
                      "seconds": report["seconds"], "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
