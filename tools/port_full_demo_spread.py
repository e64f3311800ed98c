"""The spread that rounding alone gives the phantom full demo's numbers, on
the CPU, in both packages, and on the card.

    JAX_PLATFORMS=cpu python tools/port_full_demo_spread.py [--runs 9] [--workers 2]
        [--threads 4] [--packages jax,port] [--out FILE]
    python3 tools/port_full_demo_spread.py --packages card --workers 1 --threads 8 --runs 9

Runs the phantom full demo at `OAI_DEMO_SHAPE=80,192,192` (the size of
`chip_smoke.py`'s `FULL_DEMO_TOL_80` gate) through the unchanged
JAX script `examples/full_demo.py phantom` and through the port's
`oai_analysis_2_tpu_torch.examples.full_demo.main(["phantom", dir],
device="cpu")`, each run in a process of its own, with the knee (and only
the knee: the atlas stays as it is) moved by exactly one f32 ulp at 1 %
of its voxels, drawn from the seed (`validate_registration.ulp_perturb`'s
rule):

- in the JAX child, the `image_from_array` that the script's
  `_phantom_setup` calls for the knee is wrapped (the atlas is made by
  `AnalysisObject.offline` through the same function, from another
  caller, and is left alone);
- in the port child, `full_demo._phantom_knee` is wrapped.

The same seed moves the same voxels in both packages. The package `card`
runs the port's module on the card (`device="cuda"`, on the card machine;
one worker, so that a run's seconds are its own).

The runs of a package: the unperturbed knee (seed 0), then seeds 1, 2, ...,
`--runs` in all. Each run's FC and TC inner mesh points and mean thickness,
raster coverage and mean mapped thickness (mm) at full precision (the JAX
run's numbers are read from its meshes and rasters, and held to the digits
it prints), the demo's seconds and the child's peak memory; each package's
band (min, max, mean, standard deviation) of each number over the runs
that ended well (a run that fails is reported with its exit code and the
end of its errors, and the tool then exits non-zero). One JSON object
on stdout, also written to `--out` (default the git-ignored
`build/full_demo_spread.json`). A run writes the demo's files into a
directory of its own under the git-ignored `build/full_demo_spread/` and
removes it when done. A CPU run takes 6-11 minutes and up to 24 GiB, so
keep the workers few.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import resource
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from oai_analysis_2_tpu_torch.examples.validate_registration import ulp_perturb  # noqa: E402

SHAPE, SHARE = "80,192,192", 0.01
NUMBERS = ("fc_points", "fc_mean_thickness", "fc_coverage", "fc_mapped_mean_mm",
           "tc_points", "tc_mean_thickness", "tc_coverage", "tc_mapped_mean_mm")
PRINTED = {
    "mesh": re.compile(r"^(FC|TC) mesh: (\d+) pts, mean thickness ([-\d.naninf]+)$", re.M),
    "raster": re.compile(r"^(FC|TC) 2D atlas raster: coverage ([-\d.naninf]+)%, mean thickness ([-\d.naninf]+) mm$",
                         re.M),
}


@contextlib.contextmanager
def jax_knee_perturbed(perturb):
    """The JAX script's knee moved by `perturb` = (seed, share), or not
    (None): wraps the `image_from_array` that `_phantom_setup` calls.
    Yields a dict that holds the knee handed on (`knee`) and the number of
    such calls (`knees`)."""
    import oai_analysis_2_tpu.core.image as jimage

    make = jimage.image_from_array
    seen = {"knees": 0}

    def image_from_array(data, *args, **kwargs):
        if sys._getframe(1).f_code.co_name == "_phantom_setup":
            if perturb is not None:
                data = ulp_perturb(np.asarray(data), share=perturb[1], seed=perturb[0])
            seen["knees"] += 1
            seen["knee"] = np.asarray(data)
        return make(data, *args, **kwargs)

    jimage.image_from_array = image_from_array
    try:
        yield seen
    finally:
        jimage.image_from_array = make


@contextlib.contextmanager
def port_knee_perturbed(perturb):
    """The port's knee moved by `perturb` = (seed, share), or not (None):
    wraps `full_demo._phantom_knee`. Yields a dict as `jax_knee_perturbed`
    does."""
    from oai_analysis_2_tpu_torch.examples import full_demo

    make = full_demo._phantom_knee
    seen = {"knees": 0}

    def phantom_knee(shape):
        knee = make(shape)
        if perturb is not None:
            knee = ulp_perturb(knee, share=perturb[1], seed=perturb[0])
        seen["knees"] += 1
        seen["knee"] = knee
        return knee

    full_demo._phantom_knee = phantom_knee
    try:
        yield seen
    finally:
        full_demo._phantom_knee = make


def jax_run(out_dir: str, perturb) -> dict:
    """The unchanged JAX script, `phantom out_dir`, its knee moved by
    `perturb`; the numbers read from its inner meshes and rasters."""
    import oai_analysis_2_tpu.mesh.processing as jproc

    thickness_mesh, rasterize = jproc.get_thickness_mesh, jproc.rasterize_thickness
    got = {}

    def get_thickness_mesh(prob, *args, mesh_type="FC", **kwargs):
        inner, outer = thickness_mesh(prob, *args, mesh_type=mesh_type, **kwargs)
        t = mesh_type.lower()
        got[f"{t}_points"] = int(inner.n_points)
        got[f"{t}_mean_thickness"] = float(np.mean(inner.point_data))  # as the script prints it
        return inner, outer

    def rasterize_thickness(*args, **kwargs):
        out = rasterize(*args, **kwargs)
        t = "fc" if "fc_coverage" not in got else "tc"  # the script rasterizes FC, then TC
        m, c = np.asarray(out[0]), np.asarray(out[1])
        got[f"{t}_coverage"] = float((c > 0).mean())
        got[f"{t}_mapped_mean_mm"] = float(m[c > 0].mean())
        return out

    spec = importlib.util.spec_from_file_location("jax_full_demo", ROOT / "examples" / "full_demo.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out, argv_before = io.StringIO(), sys.argv
    jproc.get_thickness_mesh, jproc.rasterize_thickness = get_thickness_mesh, rasterize_thickness
    sys.argv = ["examples/full_demo.py", "phantom", out_dir]
    try:
        with jax_knee_perturbed(perturb) as seen, contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            script.main()
            seconds = time.perf_counter() - t0
    finally:
        jproc.get_thickness_mesh, jproc.rasterize_thickness = thickness_mesh, rasterize
        sys.argv = argv_before
    if seen["knees"] != 1:
        raise RuntimeError(f"the JAX script made {seen['knees']} knees, want 1")
    text = out.getvalue()
    check_printed(got, text)
    return {**got, "seconds": seconds}


def check_printed(got: dict, text: str) -> None:
    """The numbers read from the JAX run, held to the digits it prints."""
    want = {}
    for m in PRINTED["mesh"].finditer(text):
        t = m.group(1).lower()
        want[f"{t}_points"] = f"{got[f'{t}_points']}" == m.group(2)
        want[f"{t}_mean_thickness"] = f"{got[f'{t}_mean_thickness']:.3f}" == m.group(3)
    for m in PRINTED["raster"].finditer(text):
        t = m.group(1).lower()
        want[f"{t}_coverage"] = f"{got[f'{t}_coverage']:.1%}" == f"{m.group(2)}%"
        want[f"{t}_mapped_mean_mm"] = f"{got[f'{t}_mapped_mean_mm']:.3f}" == m.group(3)
    if set(want) != set(NUMBERS) or not all(want.values()):
        raise RuntimeError(f"the numbers read {got} disagree with the JAX script's output:\n{text}")


def port_run(out_dir: str, perturb, device="cpu") -> dict:
    from oai_analysis_2_tpu_torch.examples import full_demo

    with port_knee_perturbed(perturb) as seen, contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        got = full_demo.main(["phantom", out_dir], device=device)
        seconds = time.perf_counter() - t0
    if seen["knees"] != 1:
        raise RuntimeError(f"the port made {seen['knees']} knees, want 1")
    return {**{k: got[k] for k in NUMBERS}, "seconds": seconds,
            "stage_seconds": {k: v["seconds"] for k, v in got["stages"].items()}}


def child(package: str, seed: int, cores, out_root: str) -> dict:
    """One run in this process, on `cores`: seed 0 is the unperturbed knee."""
    os.sched_setaffinity(0, cores)
    import torch

    torch.set_num_threads(len(cores))
    perturb = None if seed == 0 else (seed, SHARE)
    Path(out_root).mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix=f"{package}_seed{seed}_", dir=out_root) as out_dir:
        if package == "jax":
            got = jax_run(out_dir, perturb)
        else:
            got = port_run(out_dir, perturb, device="cuda" if package == "card" else "cpu")
    return {"package": package, "seed": seed, "threads": len(cores), **got,
            "peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}


def band(values) -> dict:
    v = np.asarray(values, np.float64)
    return {"n": int(v.size), "min": float(v.min()), "max": float(v.max()), "mean": float(v.mean()),
            "std": float(v.std(ddof=1)) if v.size > 1 else 0.0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=9, help="runs per package: seed 0 (unperturbed), 1, 2, ...")
    ap.add_argument("--workers", type=int, default=2, help="runs at once")
    ap.add_argument("--threads", type=int, default=4, help="threads a run")
    ap.add_argument("--packages", default="jax,port", help="of jax, port (both on the CPU) and card")
    ap.add_argument("--out", default=str(ROOT / "build" / "full_demo_spread.json"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--cores", help=argparse.SUPPRESS)
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    out_root = ROOT / "build" / "full_demo_spread"
    if a.child:
        print(json.dumps(child(a.child, a.seed, [int(c) for c in a.cores.split(",")], str(out_root))))
        return {}

    packages = a.packages.split(",")
    jobs = [(p, seed) for p in packages for seed in range(a.runs)]
    cores = sorted(os.sched_getaffinity(0))
    if a.workers * a.threads > len(cores):
        raise SystemExit(f"{a.workers} workers x {a.threads} threads on {len(cores)} cores")
    free = [cores[i * a.threads:(i + 1) * a.threads] for i in range(a.workers)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT), OAI_DEMO_SHAPE=SHAPE)

    def one(job):
        package, seed = job
        slot = free.pop()
        try:
            cmd = [sys.executable, str(Path(__file__).resolve()), "--child", package, "--seed", str(seed),
                   "--cores", ",".join(map(str, slot))]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT)
            if proc.returncode != 0:  # kept, so that one lost run does not lose the others
                print(f"{package} seed {seed}: exit {proc.returncode}\n{proc.stderr[-3000:]}", flush=True)
                return {"package": package, "seed": seed, "exit": proc.returncode, "stderr": proc.stderr[-3000:]}
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            got["wall_s"] = time.perf_counter() - t0
            print(f"{package} seed {seed}: " + ", ".join(f"{k} {got[k]!r}" for k in NUMBERS)
                  + f", {got['seconds']:.2f} s ({got['wall_s']:.0f} s with the process, peak "
                  f"{got['peak_rss_gib']:.1f} GiB)", flush=True)
            return got
        finally:
            free.append(slot)

    with ThreadPoolExecutor(a.workers) as pool:
        results = list(pool.map(one, jobs))
    failed = [r for r in results if "exit" in r]
    done = [r for r in results if "exit" not in r]
    bands = {p: {k: band([r[k] for r in done if r["package"] == p]) for k in NUMBERS}
             for p in packages if any(r["package"] == p for r in done)}
    for p in bands:
        for k in ("fc_mapped_mean_mm", "tc_mapped_mean_mm"):
            b = bands[p][k]
            print(f"{p} {k}: min {b['min']!r} max {b['max']!r} mean {b['mean']!r} std {b['std']!r} "
                  f"(n {b['n']})", flush=True)
    report = {"shape": SHAPE, "share": SHARE, "threads": a.threads, "runs": done, "failed": failed,
              "bands": bands}
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    if failed:
        raise SystemExit(f"{len(failed)} runs failed: " + ", ".join(f"{r['package']} seed {r['seed']}" for r in failed))
    return report


if __name__ == "__main__":
    main()
