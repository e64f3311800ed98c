"""Instance mode's loss, step by step, on the card and on the CPU in one
process: where the card's run leaves the CPU's, against the gap that a
change of rounding alone opens on the CPU.

    python3 tools/port_instance_trace.py [--cpu-seeds 0,1] [--threads 8] [--handoff SHAPE:STEPS;...]
        [--card cuda] [--out FILE] [-- VALIDATOR ARGS]

Runs the port's known-deformation validator
(`oai_analysis_2_tpu_torch.examples.validate_registration.main`, by
default in its instance configuration: the 80x192x192 phantom, 48x96x96
grid, 80/60/40 Adam steps at scales 4/2/1, lr 1.2) once on the card and
once on the CPU for each seed of `--cpu-seeds` (0: the phantom as it is;
any other: 1 % of its voxels moved by one f32 ulp, `ulp_perturb`), with
`InstanceScale.step` wrapped to read each step's loss. Prints one JSON
object: each run's mean field error and losses; per scale, the largest
gap of each scale's pooled inputs from the CPU run's; and, at steps 0, 1,
2, 5, 10, 20, 40 and the last of each scale, the relative loss gap of the
card from the unperturbed CPU run beside that of each perturbed CPU run
(the rounding envelope), and the first step at which the card's gap
exceeds ten times the envelope (or ten f32 epsilons where the envelope is
smaller).

Then, at each `--handoff` point (a scale's grid shape and step numbers;
by default steps 0, 1, 2, 5 and 20 of the first scale, 0 of the second,
0 and 10 of the last), the card is given the unperturbed CPU run's state
there (the scale's pooled inputs and base maps, u_ab, u_ba and Adam's
moments) and each intermediate is held against the CPU's
(`handoff`): each loss term's gradient, the maps, the cells the warps
sample, each element's Adam step, and the card's Adam on the CPU's
gradient. Also written to `--out` (default
`chiprun_out/port_instance_trace.json`). On the card machine about 2
minutes with 8 CPU threads; `--card cpu` holds the CPU against itself
(every gap 0), which runs anywhere.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from oai_analysis_2_tpu_torch.examples import validate_registration  # noqa: E402
from oai_analysis_2_tpu_torch.models import gradicon  # noqa: E402

REPORT_STEPS = (0, 1, 2, 5, 10, 20, 40)
# one f32 rounding of the loss, relative: the envelope's floor where the
# perturbed runs happen to round the same
F32_EPS = float(np.finfo(np.float32).eps)


def snapshot(problem) -> dict:
    """A scale's problem and Adam state, on the host."""
    state = problem.optimizer.state
    out = {k: getattr(problem, k).detach().cpu().clone() for k in ("a_s", "b_s", "base_ab", "base_ba", "u_ab", "u_ba")}
    for name in ("u_ab", "u_ba"):
        s = state.get(getattr(problem, name), {})
        out[f"{name}.m"] = s["exp_avg"].cpu().clone() if s else torch.zeros_like(out[name])
        out[f"{name}.v"] = s["exp_avg_sq"].cpu().clone() if s else torch.zeros_like(out[name])
        out["t"] = int(s["step"]) if s else 0
    return out


def traced_run(argv, device: str, seed: int, snapshots=()) -> dict:
    """The validator on `device` with each instance step's loss read; the
    pooled inputs of each scale kept on the host, and the problem's state
    before each (scale shape, step) of `snapshots`."""
    losses, inputs, snaps = {}, {}, {}
    step = gradicon.InstanceScale.step

    def recording_step(problem):
        key = "x".join(map(str, problem.a_s.shape))
        if (key, len(losses.get(key, []))) in snapshots:
            snaps[key, len(losses.get(key, []))] = snapshot(problem)
        loss = step(problem)
        if key not in losses:
            inputs[key] = (problem.a_s.cpu().numpy(), problem.b_s.cpu().numpy())
        losses.setdefault(key, []).append(float(loss))
        return loss

    gradicon.InstanceScale.step = recording_step
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            got = validate_registration.main(list(argv), device=device,
                                             perturb=None if seed == 0 else (seed, 0.01))
    finally:
        gradicon.InstanceScale.step = step
    return {"device": device, "seed": seed, "err_mean_mm": got["err_mean_mm"], "seconds": got["seconds"],
            "losses": losses, "inputs": inputs, "snapshots": snaps}


def handed_problem(snap: dict, device: str) -> gradicon.InstanceScale:
    """The scale's problem on `device` in the state of `snap`."""
    p = gradicon.InstanceScale(snap["base_ab"].to(device), snap["base_ba"].to(device), snap["a_s"].to(device),
                               snap["b_s"].to(device))
    for k in ("u_ab", "u_ba"):
        setattr(p, k, snap[k].to(device).requires_grad_(True))
    return p


def loss_terms(p) -> tuple:
    """`InstanceScale.loss`'s four terms, each weighted as it adds them, and
    the maps."""
    pab, pba = p.maps()
    wb = gradicon.warp(p.b16, pab).float()
    wa = gradicon.warp(p.a16, pba).float()
    terms = {"sim_ab": p.sim(p.a_s, wb), "sim_ba": p.sim(p.b_s, wa), "gicon": p.lambda_reg * p.penalty(pab, pba),
             "diffusion": p.diffusion_weight * (gradicon.diffusion_penalty(pab) + gradicon.diffusion_penalty(pba))}
    return terms, (pab, pba)


def adam_update(p, grads, snap):
    """One step of the optimizer `InstanceScale` makes (`utils.optim.Adam`,
    Optax's update) from `snap`'s moments and `grads`: the change of
    (u_ab, u_ba)."""
    params = [p.u_ab.detach().clone().requires_grad_(True), p.u_ba.detach().clone().requires_grad_(True)]
    opt = type(p.optimizer)(params, lr=p.optimizer.defaults["lr"], betas=(0.9, 0.999), eps=1e-8)
    for q, g, name in zip(params, grads, ("u_ab", "u_ba")):
        q.grad = g.detach().to(q.device).clone()
        if snap["t"]:
            opt.state[q] = {"step": torch.tensor(float(snap["t"])), "exp_avg": snap[f"{name}.m"].to(q.device).clone(),
                            "exp_avg_sq": snap[f"{name}.v"].to(q.device).clone()}
    opt.step()
    return [(q.detach() - p0.detach()).cpu() for q, p0 in zip(params, (p.u_ab, p.u_ba))]


def handoff(snap: dict, card_device: str = "cuda") -> dict:
    """The card given the CPU's state at a snapshot (inputs, base maps,
    u_ab, u_ba, Adam's moments): each loss term's gradient on the card
    against the CPU's (largest gap relative to the CPU's largest, and the
    elements off by more than 1e-3 of it), the maps' largest gap, the
    sample points whose cell (the floor of the index) differs in the two
    image warps, and the elements whose Adam step differs by a quarter of
    a whole step or more; then the card's Adam alone on the CPU's gradient
    against the CPU's Adam, in whole steps."""
    runs = {}
    for name, device in (("cpu", "cpu"), ("card", card_device)):
        p = handed_problem(snap, device)
        with torch.enable_grad():
            terms, maps = loss_terms(p)
            grads = {k: [torch.zeros(u.shape) if g is None else g.detach().cpu()
                         for g, u in zip(torch.autograd.grad(v, [p.u_ab, p.u_ba], allow_unused=True,
                                                             retain_graph=True), (p.u_ab, p.u_ba))]
                     for k, v in terms.items()}
        total = [sum(grads[k][i] for k in grads) for i in range(2)]
        cells = [torch.floor(gradicon._to_index(m.detach(), p.a_s.shape)).cpu() for m in maps]
        runs[name] = {"loss": {k: float(v.detach()) for k, v in terms.items()}, "grads": grads, "total": total,
                      "maps": [m.detach().cpu() for m in maps], "cells": cells,
                      "step": adam_update(p, [g.to(device) for g in total], snap)}
    cpu, card = runs["cpu"], runs["card"]
    whole = gradicon.InstanceScale(snap["base_ab"], snap["base_ba"], snap["a_s"], snap["b_s"]).optimizer.defaults["lr"]
    out = {"t": snap["t"], "loss": {k: {"cpu": cpu["loss"][k], "card": card["loss"][k]} for k in cpu["loss"]}}
    for k in cpu["grads"]:
        scale = max(float(g.abs().max()) for g in cpu["grads"][k]) or 1.0
        gap = torch.cat([(g - r).abs().flatten() for g, r in zip(card["grads"][k], cpu["grads"][k])])
        out[k] = {"max_rel": float(gap.max()) / scale, "over_1e-3": int((gap > 1e-3 * scale).sum())}
    out["maps_max_abs"] = max(float((a - b).abs().max()) for a, b in zip(card["maps"], cpu["maps"]))
    out["cells_differ"] = int(sum(int((a != b).any(-1).sum()) for a, b in zip(card["cells"], cpu["cells"])))
    out["steps_off_by_a_quarter"] = int(sum(int(((s - r).abs() >= 0.25 * whole).sum())
                                            for s, r in zip(card["step"], cpu["step"])))
    out["steps"] = int(sum(s.numel() for s in cpu["step"]))
    card_adam = adam_update(handed_problem(snap, card_device), [g.to(card_device) for g in cpu["total"]], snap)
    out["adam_alone_max_abs_in_steps"] = max(float((a - b).abs().max()) for a, b in zip(card_adam, cpu["step"])) / whole
    return out


def rel_gaps(run: dict, ref: dict) -> dict:
    return {k: (np.abs(np.asarray(run["losses"][k]) - np.asarray(v)) / np.abs(np.asarray(v))).tolist()
            for k, v in ref["losses"].items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-seeds", default="0,1", help="CPU runs; the first must be 0")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "port_instance_trace.json"))
    ap.add_argument("--handoff", default="12x24x24:0,1,2,5,20;24x48x48:0;48x96x96:0,10",
                    help="scale shape:steps;... at which the card is given the CPU's state")
    ap.add_argument("--card", default="cuda", help="the device held against the CPU (cpu: a self-check)")
    ap.add_argument("validator", nargs="*")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if a.card == "cuda" and not torch.cuda.is_available():
        raise SystemExit("port_instance_trace: needs a CUDA card")
    torch.set_num_threads(a.threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in a.cpu_seeds.split(",")]
    if seeds[0] != 0:
        raise SystemExit("--cpu-seeds must start with 0, the unperturbed phantom")
    snapshots = {(k, int(s)) for part in a.handoff.split(";") if part for k, steps in [part.split(":")]
                 for s in steps.split(",")}
    card = traced_run(a.validator, a.card, 0)
    cpus = [traced_run(a.validator, "cpu", s, snapshots if s == 0 else ()) for s in seeds]
    ref = cpus[0]
    gaps = {"card": rel_gaps(card, ref), **{f"cpu_seed{r['seed']}": rel_gaps(r, ref) for r in cpus[1:]}}
    envelope = {k: np.max([gaps[f"cpu_seed{r['seed']}"][k] for r in cpus[1:]], axis=0) for k in ref["losses"]} \
        if len(cpus) > 1 else None
    at_steps, first_departure = {}, None
    for k, v in ref["losses"].items():
        steps = sorted({s for s in REPORT_STEPS if s < len(v)} | {len(v) - 1})
        at_steps[k] = {name: {s: g[k][s] for s in steps} for name, g in gaps.items()}
        if envelope is not None and first_departure is None:
            over = np.nonzero(np.asarray(gaps["card"][k]) > 10 * np.maximum(envelope[k], F32_EPS))[0]
            if over.size:
                first_departure = {"scale_shape": k, "step": int(over[0]), "card_gap": gaps["card"][k][over[0]],
                                   "envelope": float(envelope[k][over[0]])}
    input_gaps = {k: {name: float(max(np.max(np.abs(r["inputs"][k][i] - ref["inputs"][k][i])) for i in range(2)))
                      for name, r in [("card", card)] + [(f"cpu_seed{r['seed']}", r) for r in cpus[1:]]}
                  for k in ref["inputs"]}
    report = {
        "validator_args": a.validator, "card": torch.cuda.get_device_name(0) if a.card == "cuda" else a.card,
        "runs": [{k: r[k] for k in ("device", "seed", "err_mean_mm", "seconds")} for r in [card] + cpus],
        "input_max_abs_gap": input_gaps, "rel_loss_gap_at_steps": at_steps,
        "card_first_step_beyond_10x_envelope": first_departure,
        "handoff": {f"{k}@{s}": handoff(snap, a.card) for (k, s), snap in sorted(cpus[0]["snapshots"].items())},
        "losses": {"card": card["losses"], **{f"cpu_seed{r['seed']}": r["losses"] for r in cpus}},
    }
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: v for k, v in report.items() if k != "losses"}))
    return report


if __name__ == "__main__":
    main()
