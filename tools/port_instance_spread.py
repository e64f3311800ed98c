"""The spread that rounding alone gives the instance-mode registration error,
on the CPU, in both packages, and on the card.

    JAX_PLATFORMS=cpu python tools/port_instance_spread.py [--runs 8] [--workers 4]
        [--threads 2,1] [--share 0.01] [--packages jax,port] [--out FILE] [-- VALIDATOR ARGS]
    python3 tools/port_instance_spread.py --packages card --workers 1 --threads 8 --runs 25

Runs the known-deformation validator in instance mode (by default its own
configuration: the 80x192x192 phantom, the 48x96x96 grid, 80/60/40 Adam
steps at scales 4/2/1, lr 1.2, `lncc+mse`, the alternating GradICON
gradient, no early stop) through the unchanged JAX script
`examples/validate_registration.py` and through the port's
`oai_analysis_2_tpu_torch.examples.validate_registration.main(argv,
device="cpu")`, each run in a process of its own, and changes only how
the run rounds:

- a seeded share of the phantom's voxels moved by exactly one f32 ulp
  (`validate_registration.ulp_perturb`; the port's `main(perturb=(seed,
  share))`, and for the JAX script the `image_from_array` it imports
  wrapped inside the child process, so that its first call, the phantom,
  gets the same voxels);
- the number of threads: the child's CPU affinity (which sizes XLA's
  thread pool) and `torch.set_num_threads`.

The package `card` runs the port's module on the card (`device="cuda"`,
on the card machine; one worker, so that a run's seconds are its own).

The runs of a package: the unperturbed phantom once at each thread count
of `--threads`, then seeds 1, 2, ... at the first count, `--runs` in all.
Each run's mean, median and p95 field error (mm, at full precision: the
JAX run's error is recomputed from the displacement it samples, and held
to the three digits it prints) and seconds; each package's band (min,
max, mean, standard deviation of the mean error) and both together. One
JSON object on stdout, also written to `--out` (default the git-ignored
`build/instance_spread.json`). At the default size a run takes minutes;
arguments after `--` go to both validators (e.g. `16 32 32 --net-grid
16,32,32 --inst-steps 4,4,4` for a quick check).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from oai_analysis_2_tpu_torch.examples.validate_registration import (  # noqa: E402
    ground_truth,
    parse_args,
    phantom,
    ulp_perturb,
)

PRINTED = {
    "seconds": re.compile(r"registration \(.*\) ([\d.]+)s$", re.M),
    "mse": re.compile(r"image MSE: before ([\d.]+) -> after ([\d.]+)"),
    "err": re.compile(r"mean ([\d.]+)  median ([\d.]+)  p95 ([\d.]+)"),
}


def field_errors(est: np.ndarray, pts: np.ndarray, shape) -> dict:
    """The validator's field error (mm) in the anatomy, unrounded."""
    _, shell = phantom(shape)
    mask = shell > 0.5
    err = np.linalg.norm(est[mask] - ground_truth(pts)[mask], axis=-1)
    return {"err_mean_mm": float(err.mean()), "err_median_mm": float(np.median(err)),
            "err_p95_mm": float(np.percentile(err, 95))}


def jax_run(argv, perturb) -> dict:
    """The unchanged JAX script on `argv`, its phantom perturbed by
    `perturb` = (seed, share) or not (None)."""
    import oai_analysis_2_tpu.core.image as jimage
    import oai_analysis_2_tpu.ops.resample as jresample

    make_image, sample = jimage.image_from_array, jresample.sample_displacement
    seen = {"images": 0}

    def image_from_array(data, *args, **kwargs):
        if seen["images"] == 0 and perturb is not None:  # the first image the script makes: its phantom
            data = ulp_perturb(np.asarray(data), share=perturb[1], seed=perturb[0])
        seen["images"] += 1
        return make_image(data, *args, **kwargs)

    def sample_displacement(disp, pts):
        out = sample(disp, pts)
        seen["est"], seen["pts"] = out, pts  # the last call is the script's error read
        return out

    spec = importlib.util.spec_from_file_location("jax_validate_registration",
                                                  ROOT / "examples" / "validate_registration.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out, argv_before = io.StringIO(), sys.argv
    jimage.image_from_array, jresample.sample_displacement = image_from_array, sample_displacement
    sys.argv = ["examples/validate_registration.py", *argv]
    try:
        with contextlib.redirect_stdout(out):
            script.main()
    finally:
        jimage.image_from_array, jresample.sample_displacement = make_image, sample
        sys.argv = argv_before
    text = out.getvalue()
    printed = {k: r.search(text) for k, r in PRINTED.items()}
    if not all(printed.values()):
        raise RuntimeError(f"unexpected output of the JAX script:\n{text}")
    got = field_errors(np.asarray(seen["est"]), np.asarray(seen["pts"]), parse_args(argv)["shape"])
    if f"{got['err_mean_mm']:.3f}" != printed["err"].group(1):
        raise RuntimeError(f"recomputed mean error {got['err_mean_mm']} against the printed {printed['err'].group(1)}")
    before, after = (float(v) for v in printed["mse"].groups())
    return {**got, "seconds": float(printed["seconds"].group(1)), "mse_ratio": after / before if before else None}


def port_run(argv, perturb, device="cpu") -> dict:
    from oai_analysis_2_tpu_torch.examples import validate_registration

    with contextlib.redirect_stdout(io.StringIO()):
        got = validate_registration.main(list(argv), device=device, perturb=perturb)
    return {k: got[k] for k in ("err_mean_mm", "err_median_mm", "err_p95_mm", "seconds", "mse_ratio")}


def child(package: str, argv, seed: int, share: float, cores) -> dict:
    """One run in this process, on `cores`: seed 0 is the unperturbed phantom."""
    os.sched_setaffinity(0, cores)
    import torch

    torch.set_num_threads(len(cores))
    perturb = None if seed == 0 else (seed, share)
    if package == "jax":
        got = jax_run(argv, perturb)
    else:
        got = port_run(argv, perturb, device="cuda" if package == "card" else "cpu")
    return {"package": package, "seed": seed, "threads": len(cores), **got}


def plan(runs: int, threads) -> list:
    """(seed, threads) of a package's runs: seed 0 at each thread count,
    then seeds 1, 2, ... at the first."""
    out = [(0, t) for t in threads]
    out += [(s, threads[0]) for s in range(1, runs - len(out) + 1)]
    return out[:runs]


def band(values) -> dict:
    v = np.asarray(values, np.float64)
    return {"n": int(v.size), "min": float(v.min()), "max": float(v.max()), "mean": float(v.mean()),
            "std": float(v.std(ddof=1)) if v.size > 1 else 0.0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=8, help="runs per package")
    ap.add_argument("--workers", type=int, default=4, help="runs at once")
    ap.add_argument("--threads", default="2,1", help="thread counts; the first is every perturbed run's")
    ap.add_argument("--share", type=float, default=0.01, help="share of the voxels moved by one ulp")
    ap.add_argument("--packages", default="jax,port", help="of jax, port (both on the CPU) and card")
    ap.add_argument("--out", default=str(ROOT / "build" / "instance_spread.json"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--cores", help=argparse.SUPPRESS)
    ap.add_argument("validator", nargs="*", help="arguments for both validators (after --)")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if a.child:
        print(json.dumps(child(a.child, a.validator, a.seed, a.share, [int(c) for c in a.cores.split(",")])))
        return {}

    threads = [int(t) for t in a.threads.split(",")]
    packages = a.packages.split(",")
    jobs = [(p, seed, t) for p in packages for seed, t in plan(a.runs, threads)]
    cores = sorted(os.sched_getaffinity(0))
    per_slot = max(1, len(cores) // a.workers)
    if max(threads) > per_slot:
        raise SystemExit(f"{a.workers} workers on {len(cores)} cores leave {per_slot} a run; --threads {a.threads}")
    free = [cores[i * per_slot:(i + 1) * per_slot] for i in range(a.workers)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))

    def one(job):
        package, seed, t = job
        slot = free.pop()
        try:
            cmd = [sys.executable, str(Path(__file__).resolve()), "--child", package, "--seed", str(seed),
                   "--share", str(a.share), "--cores", ",".join(map(str, slot[:t])), "--", *a.validator]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT)
            if proc.returncode != 0:
                raise RuntimeError(f"{package} seed {seed}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            got["wall_s"] = time.perf_counter() - t0
            print(f"{package} seed {seed} threads {t}: mean {got['err_mean_mm']:.6f} mm "
                  f"({got['wall_s']:.0f} s)", file=sys.stderr, flush=True)
            return got
        finally:
            free.append(slot)

    with ThreadPoolExecutor(a.workers) as pool:
        results = list(pool.map(one, jobs))
    bands = {p: band([r["err_mean_mm"] for r in results if r["package"] == p]) for p in packages}
    if len(packages) > 1:
        bands["combined"] = band([r["err_mean_mm"] for r in results])
    report = {"validator_args": a.validator, "share": a.share, "threads": threads, "runs": results,
              "bands": bands}
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
