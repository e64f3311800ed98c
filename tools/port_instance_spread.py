"""The spread that rounding alone gives the instance-mode registration error,
on the CPU, in both packages, and on the card.

    JAX_PLATFORMS=cpu python tools/port_instance_spread.py [--runs 8] [--workers 4]
        [--threads 2,1] [--share 0.01] [--packages jax,port] [--seeds S,...] [--lr LR]
        [--out FILE] [-- VALIDATOR ARGS]
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
The package `jax_steps` runs the JAX script with its instance steps taken
one jitted `opt_step` at a time (`bind_instance`): the same arithmetic as
`jax`, compiled as XLA programs of another cut. A package
`port+PART+...` runs the port's module with each PART of `JAX_PARTS`
taken from JAX: `grad` each instance step's gradient, `step` the whole
step with optax's Adam (`jax_step`), `images` the JAX script's grid
images for the same perturbation (`jax_grid_images`), `pyramid` the
pooled images (`jax_pyramid`), `finish` the compose and resize that end a
scale (`jax_finish`). `--base B` first moves every run's phantom by one
ulp at half its voxels (seed B, `rebased`): the same runs about another
base.

The runs of a package: the unperturbed phantom once at each thread count
of `--threads`, then seeds 1, 2, ... at the first count, `--runs` in all;
or the seeds of `--seeds` alone, at the first count. `--lr` sets the
instance lr (voxels a step; the JAX script has no flag for it): the child
binds it into each package's `register_pair_instance` as its
`register_pair` calls it, so it moves instance mode alone (a fine-tune
passes its own lr). With `--lr`, the runs repeat at each lr given and
the report's `lr_sweep` takes the place of `bands` (`lr_sweep`).
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
import functools
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


# `--base`: the share of the phantom's voxels that a base seed moves by an
# ulp before a run's own perturbation
BASE_SHARE = 0.5


def rebased(vol, base):
    """The phantom `vol` moved to the base of seed `base` (None: as it is)."""
    return vol if base is None else ulp_perturb(np.asarray(vol), share=BASE_SHARE, seed=base)


def jax_run(argv, perturb, base=None) -> dict:
    """The unchanged JAX script on `argv`, its phantom moved to `base`
    (`rebased`) and perturbed by `perturb` = (seed, share) or not (None)."""
    import oai_analysis_2_tpu.core.image as jimage
    import oai_analysis_2_tpu.ops.resample as jresample

    make_image, sample = jimage.image_from_array, jresample.sample_displacement
    seen = {"images": 0}

    def image_from_array(data, *args, **kwargs):
        if seen["images"] == 0:  # the first image the script makes: its phantom
            data = rebased(data, base)
            if perturb is not None:
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


# what a `port+PART` package takes from JAX (`bind_instance`)
JAX_PARTS = ("grad", "step", "images", "pyramid", "finish")


def load_handoff():
    spec = importlib.util.spec_from_file_location("port_instance_handoff", ROOT / "tools" / "port_instance_handoff.py")
    handoff = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(handoff)
    return handoff


def jax_step(problem, adam: bool = False):
    """`InstanceScale.step` with the loss and its gradient taken by JAX
    (the hand-off tool's replica of `_scale_run_fn`'s loss_fn) on the
    problem's own state and the port's Adam on it; with `adam`, the whole
    step JAX's own `opt_step` (optax's Adam, its state kept beside the
    problem's) and u copied back."""
    import jax.numpy as jnp
    import optax
    import torch

    us = (problem.u_ab, problem.u_ba)
    if not hasattr(problem, "jax_args"):
        shape = tuple(problem.a_s.shape)
        problem.jax_fns = load_handoff().jax_fns(shape, problem.optimizer.defaults["lr"] * max(shape))
        problem.jax_args = tuple(jnp.asarray(getattr(problem, k).cpu().numpy())
                                 for k in ("base_ab", "base_ba", "a_s", "b_s"))
        params = {k: jnp.asarray(u.detach().cpu().numpy()) for k, u in zip(("u_ab", "u_ba"), us)}
        problem.jax_state = (params, optax.adam(problem.optimizer.defaults["lr"]).init(params))
    if adam:
        params, opt_state, loss = problem.jax_fns["opt_step"](*problem.jax_state, *problem.jax_args)
        problem.jax_state = (params, opt_state)
        with torch.no_grad():
            for k, u in zip(("u_ab", "u_ba"), us):
                u.copy_(torch.from_numpy(np.array(params[k])))
        return torch.tensor(float(loss))
    params = {k: jnp.asarray(u.detach().cpu().numpy()) for k, u in zip(("u_ab", "u_ba"), us)}
    loss, grad = problem.jax_fns["total"](params, *problem.jax_args)
    for k, u in zip(("u_ab", "u_ba"), us):
        u.grad = torch.from_numpy(np.array(grad[k])).to(u.device)
    problem.optimizer.step()
    return torch.tensor(float(loss))


def jax_pyramid(volume, scale):
    """`gradicon.pyramid` by JAX's `downsample2x`, eagerly, as JAX's
    `register_pair_instance` pools."""
    import jax.numpy as jnp
    import torch

    from oai_analysis_2_tpu.models import gradicon as JG

    out = jnp.asarray(volume.cpu().numpy())
    for _ in range(int.bit_length(int(scale)) - 1):
        out = JG.downsample2x(out)
    return torch.from_numpy(np.array(out)).to(volume.device)


def jax_finish(problem, full_shape):
    """`InstanceScale.finish` by JAX's jitted compose and resize to the full
    grid, as `_scale_run_fn`'s program ends."""
    import jax.numpy as jnp
    import torch

    from oai_analysis_2_tpu.models import gradicon as JG

    finish = load_handoff()._finish(JG._identity_map_np(tuple(problem.a_s.shape)), tuple(full_shape))
    params = {k: jnp.asarray(getattr(problem, k).detach().cpu().numpy()) for k in ("u_ab", "u_ba")}
    out = finish(params, jnp.asarray(problem.base_ab.cpu().numpy()), jnp.asarray(problem.base_ba.cpu().numpy()))
    return tuple(torch.from_numpy(np.array(m)).to(problem.a_s.device) for m in out)


class _GridImages(Exception):
    """Raised by `jax_grid_images`' stand-in to stop the JAX script."""


def jax_grid_images(argv, perturb, base=None) -> tuple:
    """The two grid images the JAX script hands `register_pair_instance`
    (its run stopped there), as numpy."""
    import oai_analysis_2_tpu.engine.registration as registration

    own = registration.register_pair_instance

    def stop(a, b, **kwargs):
        raise _GridImages(np.asarray(a), np.asarray(b))

    registration.register_pair_instance = stop
    try:
        jax_run(argv, perturb, base)
    except _GridImages as got:
        return got.args
    finally:
        registration.register_pair_instance = own
    raise RuntimeError("the JAX script never reached register_pair_instance")


def bind_instance(package: str, lr, images=None) -> None:
    """The package's instance run as its `engine.registration` calls it:
    for `jax_steps`, JAX's `register_pair_instance` replaced by
    `tools/port_instance_handoff.py`'s `stepwise_instance` (the same steps,
    one jitted `opt_step` at a time); for `port+PART+...`, the port's with
    each part of `JAX_PARTS` taken from JAX (`images` the JAX script's grid
    images); `lr`, unless None, bound into `register_pair_instance`."""
    base, *parts = package.split("+")
    if base.startswith("jax"):
        import oai_analysis_2_tpu.engine.registration as registration
    else:
        import oai_analysis_2_tpu_torch.engine.registration as registration
        from oai_analysis_2_tpu_torch.models import gradicon
    if base == "jax_steps":
        registration.register_pair_instance = load_handoff().stepwise_instance(set(), {})
    if "grad" in parts or "step" in parts:
        whole = "step" in parts
        gradicon.InstanceScale.step = lambda problem: jax_step(problem, whole)
    if "pyramid" in parts:
        gradicon.pyramid = jax_pyramid
    if "finish" in parts:
        gradicon.InstanceScale.finish = jax_finish
    if "images" in parts:
        import torch

        own = registration.register_pair_instance

        def on_jax_images(a, b, **kwargs):
            return own(*(torch.as_tensor(v, device=a.device) for v in images), **kwargs)

        registration.register_pair_instance = on_jax_images
    if lr is not None:
        registration.register_pair_instance = functools.partial(registration.register_pair_instance, lr=lr)


def child(package: str, argv, seed: int, share: float, cores, lr=None, base=None) -> dict:
    """One run in this process, on `cores`: seed 0 is the unperturbed
    phantom (or its `base`)."""
    os.sched_setaffinity(0, cores)
    import torch

    torch.set_num_threads(len(cores))
    perturb = None if seed == 0 else (seed, share)
    if base is not None:
        from oai_analysis_2_tpu_torch.examples import validate_registration

        make = validate_registration.phantom

        def phantom(shape):
            vol, shell = make(shape)
            return rebased(vol, base), shell

        validate_registration.phantom = phantom
    bind_instance(package, lr, jax_grid_images(argv, perturb, base) if "images" in package.split("+") else None)
    if package.startswith("jax"):
        got = jax_run(argv, perturb, base)
    else:
        got = port_run(argv, perturb, device="cuda" if package == "card" else "cpu")
    return {"package": package, "seed": seed, "threads": len(cores), "lr": lr, "base": base, **got}


def plan(runs: int, threads) -> list:
    """(seed, threads) of a package's runs: seed 0 at each thread count,
    then seeds 1, 2, ... at the first."""
    out = [(0, t) for t in threads]
    out += [(s, threads[0]) for s in range(1, runs - len(out) + 1)]
    return out[:runs]


# the lr sweep: a package's runs within this (mm) of each other are
# deterministic, and two deterministic packages agree within the network
# modes' tolerance (chip_smoke.VALIDATE_TOL_MM)
DETERMINISTIC_MM, AGREE_MM = 1e-3, 0.02


def band(values) -> dict:
    v = np.asarray(values, np.float64)
    return {"n": int(v.size), "min": float(v.min()), "max": float(v.max()), "mean": float(v.mean()),
            "std": float(v.std(ddof=1)) if v.size > 1 else 0.0}


def lr_sweep(results, packages, lrs) -> dict:
    """Per lr: each package's band; a package whose runs agree within
    `DETERMINISTIC_MM` is deterministic there, and two deterministic
    packages must agree within `AGREE_MM`; the gap of the packages' means
    against both spreads (max - min); and the lowest lr whose gap exceeds
    both."""
    out = {"per_lr": {}, "gap_opens_at_lr": None}
    for lr in lrs:
        bands = {p: band([r["err_mean_mm"] for r in results if r["package"] == p and r["lr"] == lr])
                 for p in packages}
        spread = {p: b["max"] - b["min"] for p, b in bands.items()}
        row = {"bands": bands, "spread_mm": spread,
               "deterministic": {p: v <= DETERMINISTIC_MM for p, v in spread.items()}}
        if len(packages) == 2:
            gap = bands[packages[1]]["mean"] - bands[packages[0]]["mean"]
            row["gap_mm"] = gap
            row["gap_exceeds_spreads"] = abs(gap) > max(spread.values())
            if all(row["deterministic"].values()):
                row["agree_within_tol"] = abs(gap) <= AGREE_MM
            if row["gap_exceeds_spreads"] and out["gap_opens_at_lr"] is None:
                out["gap_opens_at_lr"] = lr
        out["per_lr"][repr(lr)] = row
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=8, help="runs per package")
    ap.add_argument("--workers", type=int, default=4, help="runs at once")
    ap.add_argument("--threads", default="2,1", help="thread counts; the first is every perturbed run's")
    ap.add_argument("--share", type=float, default=0.01, help="share of the voxels moved by one ulp")
    ap.add_argument("--packages", default="jax,port",
                    help="of jax, jax_steps, port, port+PART+... (PART of JAX_PARTS; on the CPU) and card")
    ap.add_argument("--seeds", help="the seeds to run (at the first thread count), in place of --runs")
    ap.add_argument("--base", type=int, help="every run's phantom first moved by one ulp at half its voxels "
                    "(`rebased`) from this seed")
    ap.add_argument("--lr", help="instance mode's lr, or several (comma-separated) for a sweep; "
                    "default the package's, 1.2")
    ap.add_argument("--out", default=str(ROOT / "build" / "instance_spread.json"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--cores", help=argparse.SUPPRESS)
    ap.add_argument("validator", nargs="*", help="arguments for both validators (after --)")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if a.child:
        lr = None if a.lr is None else float(a.lr)
        print(json.dumps(child(a.child, a.validator, a.seed, a.share, [int(c) for c in a.cores.split(",")], lr,
                               a.base)))
        return {}

    threads = [int(t) for t in a.threads.split(",")]
    packages = a.packages.split(",")
    bad = [p for p in packages if p.split("+")[0] not in ("jax", "jax_steps", "port", "card")
           or (set(p.split("+")[1:]) - set(JAX_PARTS)) or ("+" in p and not p.startswith("port+"))]
    if bad:
        raise SystemExit(f"unknown packages {bad}")
    runs = [(int(seed), threads[0]) for seed in a.seeds.split(",")] if a.seeds else plan(a.runs, threads)
    lrs = [None] if a.lr is None else [float(v) for v in a.lr.split(",")]
    jobs = [(p, seed, t, lr) for lr in lrs for p in packages for seed, t in runs]
    cores = sorted(os.sched_getaffinity(0))
    per_slot = max(1, len(cores) // a.workers)
    if max(threads) > per_slot:
        raise SystemExit(f"{a.workers} workers on {len(cores)} cores leave {per_slot} a run; --threads {a.threads}")
    free = [cores[i * per_slot:(i + 1) * per_slot] for i in range(a.workers)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))

    def one(job):
        package, seed, t, lr = job
        slot = free.pop()
        try:
            cmd = [sys.executable, str(Path(__file__).resolve()), "--child", package, "--seed", str(seed),
                   "--share", str(a.share), "--cores", ",".join(map(str, slot[:t])),
                   *(["--lr", repr(lr)] if lr is not None else []),
                   *(["--base", str(a.base)] if a.base is not None else []), "--", *a.validator]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT)
            if proc.returncode != 0:
                raise RuntimeError(f"{package} seed {seed}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            got["wall_s"] = time.perf_counter() - t0
            print(f"{package} seed {seed} threads {t} lr {lr}: mean {got['err_mean_mm']:.6f} mm "
                  f"({got['wall_s']:.0f} s)", file=sys.stderr, flush=True)
            return got
        finally:
            free.append(slot)

    with ThreadPoolExecutor(a.workers) as pool:
        results = list(pool.map(one, jobs))
    report = {"validator_args": a.validator, "share": a.share, "threads": threads, "runs": results}
    if lrs == [None]:
        report["bands"] = {p: band([r["err_mean_mm"] for r in results if r["package"] == p]) for p in packages}
        if len(packages) > 1:
            report["bands"]["combined"] = band([r["err_mean_mm"] for r in results])
    else:
        report["lr_sweep"] = lr_sweep(results, packages, lrs)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
