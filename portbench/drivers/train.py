"""Driver of GradICON training configurations: builds the network, Adam
with the global-norm clip and `make_augmented_train_step` as the port's
trainer builds them, drives that one step object from the seed through its
first steps in set-up, then runs steps back to back for the window, and
has the plain reference (`portbench/reference/train.py`) follow the first
steps from the same weights and batches.

Set-up (counted in `setup_s`): the weights drawn on the card from the
seed in one call, the phantom pool and the bank of pairs made on the card,
the first `followed_steps` steps (which also build and warm every kernel).
The window starts whole steps until `--seconds` have passed.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Dict, List

import numpy as np

from portbench import gen, roofline
from portbench.harness import Cell, Run
from portbench.reference.knee import stage_spec


def _stage_leaves(width: int):
    """[(block, leaf, shape)] of one stage in the network's order."""
    enc, dec = stage_spec(width)
    out = []
    cin = 2
    for li, (ca, cb) in enumerate(enc):
        out += [(f"enc{li}a", (3, 3, 3, cin, ca)), (f"enc{li}b", (3, 3, 3, ca, cb))]
        cin = cb
    cur = enc[-1][1]
    for li, (cu, c1, c2) in enumerate(dec):
        skip = enc[len(enc) - 2 - li][1]
        out += [(f"dec{li}up", (2, 2, 2, cur, cu)), (f"dec{li}a", (3, 3, 3, cu + skip, c1)),
                (f"dec{li}b", (3, 3, 3, c1, c2))]
        cur = c2
    out.append(("head", (1, 1, 1, dec[-1][2], 3)))
    return out


def init_weights(cfg: dict, seed: int, device) -> List[Dict[str, Dict[str, object]]]:
    """Each stage's weights drawn on the card in one call: Xavier-normal
    kernels (std sqrt(2 / (taps Cin + taps Cout))), zero biases, the heads
    zero so the untrained network is the identity."""
    import torch

    m = cfg["model"]
    blocks = _stage_leaves(m["stage_width"])
    sizes = [int(np.prod(s)) for _, s in blocks] * len(m["scales"])
    gen_ = torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + 5) % (2**63 - 1))
    draws = torch.randn(sum(sizes), generator=gen_, device=device)
    out, at = [], 0
    for _ in m["scales"]:
        stage = {}
        for name, shape in blocks:
            n = int(np.prod(shape))
            taps = shape[0] * shape[1] * shape[2]
            std = math.sqrt(2.0 / (taps * shape[3] + taps * shape[4]))
            k = draws[at : at + n].reshape(shape) * std
            if name == "head" and m["init"]["zero_heads"]:
                k = torch.zeros_like(k)
            stage[name] = {"kernel": k, "bias": torch.zeros(shape[-1], device=device)}
            at += n
        out.append(stage)
    return out


def step_work(cfg: dict) -> dict:
    """A step's work: every 3x3x3 conv forward, its data gradient (not for
    the first stage's first conv, whose input needs none) and its weight
    gradient in the compute type; the upconvs and heads as f32 products
    three times (forward and two gradients); for both directions of each
    pair. "sm90n" lists what the sm90n kernel was written for."""
    m = cfg["model"]
    dt = m["compute_dtype"]
    enc, dec = stage_spec(m["stage_width"])
    reps = 2 * cfg["batch_pairs"]
    all_, sm90n, pw = [], [], []
    launches = 0
    for si, scale in enumerate(m["scales"]):
        shape = [s // scale for s in m["grid_shape"]]
        for name, level, cin, cout in roofline.unet_convs(enc, dec, 2):
            v = roofline.level_voxels(shape, level)
            f, b = roofline.conv3x3_work(v, cin, cout, dt)
            has_dgrad = not (si == 0 and name == "enc0a")
            all_ += [(reps * f, reps * b, dt)] * (3 if has_dgrad else 2)
            if roofline.sm90n_takes(cin, cout):
                sm90n.append((reps * f, reps * b, dt))
                launches += reps
            if has_dgrad and roofline.sm90n_takes(cout, cin):
                fd, bd = roofline.conv3x3_work(v, cout, cin, dt, bias=False)
                sm90n.append((reps * fd, reps * bd, dt))
                launches += reps
        for _n, level, cin, cout in roofline.unet_pointwise(enc, dec, 3):
            pw.append((3 * reps * roofline.pointwise_work(roofline.level_voxels(shape, level), cin, cout), 0.0,
                       "float32"))
    return {"all": all_ + pw, "sm90n": sm90n, "sm90n_launches": launches}


def _leaf_gaps(prog: List, ref: List, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    pn = [float(t.double().norm()) for t in prog]
    rn = [float(t.double().norm()) for t in ref]
    idx = [i for i in range(len(rn)) if keep is None or keep[i]]
    med = float(np.median([rn[i] for i in idx]))
    return max(abs(pn[i] - rn[i]) / max(rn[i], med, 1e-30) for i in idx)


def judge(cfg: dict, init, batches, losses, first_grads, weights, leaves, prec_name=None) -> dict:
    """The numbers compared: loss_gap, the largest relative gap of a step's
    loss; grad_norm_gap, of the first step's gradient as Adam took it;
    change_norm_gap, of the weights' change over the followed steps, leaving
    out leaves whose reference gradient is under `leaf_floor` of the median
    leaf's (they move by round-off alone)."""
    from portbench.reference.ops import Precision
    from portbench.reference.train import follow

    ref = follow(cfg, init, batches, Precision(prec_name or cfg["model"]["compute_dtype"]))
    assert [tuple(x) for x in ref["leaves"]] == [tuple(x) for x in leaves]
    rl = ref["losses"]
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(losses, rl))
    gnorm = [float(g.double().norm()) for g in ref["first_grads"]]
    med = float(np.median(gnorm))
    keep = [g >= cfg["correctness"]["leaf_floor"] * med for g in gnorm]
    init_flat = [init[i][b][k] for i, b, k in leaves]
    d_prog = [w - w0 for w, w0 in zip(weights, init_flat)]
    d_ref = [w - w0 for w, w0 in zip(ref["weights"], init_flat)]
    return {"loss_gap": loss_gap, "grad_norm_gap": _leaf_gaps(first_grads, ref["first_grads"]),
            "change_norm_gap": _leaf_gaps(d_prog, d_ref, keep), "leaves_left_out": float(len(keep) - sum(keep))}


def _state_unchanged(step, opt):
    def broken(*batch):
        saved = [p.detach().clone() for p in opt.params]
        out = step(*batch)
        for p, s in zip(opt.params, saved):
            p.data.copy_(s)
        return out

    return broken


def _half_batch(step, opt):
    def broken(*batch):
        return step(*(t[: t.shape[0] // 2] for t in batch))

    return broken


# Faults planted under the timed path (tests and calibration only): a step
# that leaves its state unchanged; half of the batch left out, the mean
# taken over the rest.
FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch}


def run(cell: Cell, fault=None) -> Run:
    """`fault` (tests only): a function of the step that returns a broken
    step, applied before the first step."""
    import torch

    from oai_analysis_2_tpu_torch.models.gradicon import GradICON, GradICONConfig
    from oai_analysis_2_tpu_torch.models.synthetic import make_augmented_train_step
    from oai_analysis_2_tpu_torch.ops import cuda_conv
    from oai_analysis_2_tpu_torch.utils import optim
    from portbench.harness import Trace

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    m, o = cfg["model"], cfg["optimizer"]
    init = init_weights(cfg, cell.seed, dev)
    gcfg = GradICONConfig(grid_shape=tuple(m["grid_shape"]), scales=tuple(m["scales"]),
                          stage_width=m["stage_width"], lncc_window=m["lncc_window"], lambda_reg=m["lambda_reg"],
                          displacement_scale=m["displacement_scale"], similarity=m["similarity"],
                          mse_weight=m["mse_weight"])
    model = GradICON(gcfg, compute_dtype=getattr(torch, m["compute_dtype"]), device=dev)
    model.load_params([{b: {k: v.cpu().numpy() for k, v in leaves.items()} for b, leaves in st.items()}
                       for st in init])
    named = dict(model.named_parameters())
    leaves = [(i, b, k) for i, st in enumerate(init) for b in sorted(st) for k in sorted(st[b])]
    params = [named[f"stages.{i}.{b}.{k}"] for i, b, k in leaves]
    opt = optim.adam(params, o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"], clip_norm=o["clip_norm"])
    step = make_augmented_train_step(model, opt, sup_weight=cfg["sup_weight"], sim_weight=cfg["sim_weight"])
    if fault is not None:
        step = fault(step, opt)
    pool = gen.phantom_pool(cfg, tr, cell.seed, dev)
    bank = gen.pair_bank(cfg, tr, cell.seed, dev)

    def batch(i):
        j = i % tr["bank_steps"]
        return (pool[bank["ia"][j]], pool[bank["ib"][j]], bank["ua"][j], bank["ub"][j], bank["same"][j])

    n_follow = cfg["correctness"]["followed_steps"]
    losses, first_grads = [], None
    for s in range(n_follow):
        out = step(*batch(s))
        losses.append(float(out[0]))
        if s == 0:
            first_grads = [opt.adam.state[p]["exp_avg"].detach() / (1 - o["b1"]) for p in params]
    weights = [p.detach().clone() for p in params]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - cell.t_start

    tracer = Trace() if cell.trace else None
    traced = {"n": 0}
    failed = 0
    step_s = []
    t_wall = time.time()
    t0 = time.perf_counter()
    t_last = t0
    i = n_follow
    done = 0
    while done == 0 or t_last - t0 < cell.seconds:
        tracing = tracer is not None and done < tr["trace_steps"]
        if tracing and done == 0:
            cuda_conv.reset_launches()
            tracer.__enter__()
        ts = t_last
        out = step(*batch(i))
        if not bool(torch.isfinite(out[0])):
            failed += 1
        t_last = time.perf_counter()
        if not tracing:
            step_s.append(t_last - ts)
        done += 1
        i += 1
        if tracing:
            traced["n"] += 1
            if done == tr["trace_steps"] or t_last - t0 >= cell.seconds:
                tracer.__exit__(None, None, None)
                traced["launches_sm90n"] = cuda_conv.conv3d.launches_sm90n
                tracer_done, tracer = tracer, None
    window_s = t_last - t0
    print("window: " + json.dumps({"steps": done, "seconds": round(window_s, 4), "at": round(t_wall, 3),
                                   "step_s": roofline.spread_summary(step_s)}), file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics = {"unit_of_work": "pairs", "setup_s": setup_s,
               "window": {"completed": done * cfg["batch_pairs"], "seconds": window_s}}
    if cell.trace:
        red = tracer_done.reduce()
        w = step_work(cfg)
        red.update(traced_items=traced["n"], launches_sm90n=traced["launches_sm90n"],
                   expected_sm90n=w["sm90n_launches"] * traced["n"],
                   sm90n_work=roofline.sum_work(w["sm90n"] * traced["n"]),
                   model_work=roofline.sum_work(w["all"] * traced["n"]))
        metrics["trace"] = red

    batches = [batch(s) for s in range(n_follow)]
    del model, opt, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = judge(cfg, init, batches, losses, first_grads, weights, leaves)
    checks = [(name, readings[name], float(v)) for name, v in cfg["correctness"]["limits"].items()]
    return Run(metrics=metrics, checks=checks, attempted=done, failed=failed, memory_peak_bytes=peak,
               details={"readings": readings, "losses": losses})


def control(cell: Cell) -> dict:
    """The numbers compared when the reference in the control's precision
    stands in the program's place for the followed steps."""
    import torch

    from portbench.reference.ops import Precision
    from portbench.reference.train import follow

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    init = init_weights(cfg, cell.seed, dev)
    pool = gen.phantom_pool(cfg, tr, cell.seed, dev)
    bank = gen.pair_bank(cfg, tr, cell.seed, dev)
    batches = [(pool[bank["ia"][s]], pool[bank["ib"][s]], bank["ua"][s], bank["ub"][s], bank["same"][s])
               for s in range(cfg["correctness"]["followed_steps"])]
    c = follow(cfg, init, batches, Precision(cfg["correctness"]["control"]))
    with torch.no_grad():
        return judge(cfg, init, batches, c["losses"], c["first_grads"], c["weights"], c["leaves"])
