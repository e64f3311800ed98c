"""Instance mode, JAX against the port, one Adam step at a time, on the CPU:
the JAX package's own trajectory handed to the port's `InstanceScale` at
chosen steps, and every op's gap held against the gap that a one-ulp change
of the handed state opens in JAX itself.

    JAX_PLATFORMS=cpu python tools/port_instance_handoff.py [--threads 8]
        [--points "4:0,1,2,3,5,10,20,40,79;2:0,10,59;1:0,39"] [--envelope-seeds 1,2]
        [--out FILE] [-- VALIDATOR ARGS]

Runs the unchanged JAX script `examples/validate_registration.py` in its
instance configuration (by default the 80x192x192 phantom, the 48x96x96
grid, 80/60/40 Adam steps at scales 4/2/1, lr 1.2, `lncc+mse`, the
alternating GradICON gradient) twice in this process:

1. as it is: each scale one jitted `fori_loop` program;
2. with `register_pair_instance` replaced by `stepwise_instance`, the same
   per-scale sequence driven one step at a time through JAX's own
   `opt_step` (`_scale_run_fn(...)[1]`), the state kept before each step of
   `--points` (scale factor: steps).

It prints the gap between the two runs' mean field errors and maps. Then,
at each kept state (the scale's pooled images and base maps, u_ab, u_ba,
Adam's moments and step count), `handoff_point` evaluates in both packages:
each term's value and gradient (the similarity with its bf16 warps, the
weighted GradICON penalty, the weighted diffusion term), the summed
gradient, and the Adam update (the change of u_ab and u_ba, in whole steps
of lr / max(grid)); and the port's Adam alone on JAX's gradient. The
rounding envelope is JAX against itself with every element of the handed
state moved by one f32 ulp, up or down at random (`--envelope-seeds`).
Each op is compared in three element classes of its gradient (the summed
gradient for the update): `large`, |g| at least 1e-4 of the largest;
`small`, below that; `zero_xor`, exactly 0 in one run and not in the other.
Per class: the count, the largest gap, the signed mean of (other - JAX),
its rms, and the share of elements whose signs disagree.

An op departs at a point when, in some class, its largest gap exceeds ten
times the envelope's, or its signed mean exceeds ten times the envelope's
bias: the largest of the envelope's |signed mean| and the standard error
of the op's own mean, its count's root under the envelope's rms or under
its own (a mean that its own scatter does not tell from 0 is no bias). A class that is empty in the envelope is held against the
envelope's `small` class. A loss term's value departs beyond ten times
its envelope floored at sqrt(n) f32 epsilons of the value (n the elements
of u_ab and u_ba): a change of summation order alone moves a mean that
far, while the one-ulp move often leaves it as it was. The last line names the first op that departs,
or says that none does. JSON in `--out` (default the git-ignored
`build/instance_handoff.json`). About 10 minutes with 8 threads at the
default size; `-- 16 32 32 --net-grid 16,32,32 --inst-steps 6,6,6` with
`--points "4:0,3;2:0;1:5"` for a check in about 2 minutes. It runs on the
CPU: the card machine has no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DEFAULT_POINTS = "4:0,1,2,3,5,10,20,40,79;2:0,10,59;1:0,39"
CLASSES = ("large", "small", "zero_xor")
SMALL_SHARE = 1e-4  # |g| below this share of the largest: the small class
DEPART = 10.0  # an op departs beyond this many envelopes
# the validator's instance loss (register_pair's defaults)
LNCC_WINDOW, LAMBDA_REG, DIFFUSION_WEIGHT, SIMILARITY = 5, 0.5, 0.3, "lncc+mse"
STATE_KEYS = ("a_s", "b_s", "base_ab", "base_ba", "u_ab", "u_ba", "m_ab", "m_ba", "v_ab", "v_ba")
# the ops compared, each with the name of the gradient that classes its elements
OPS = (("sim", "sim"), ("gicon", "gicon"), ("diffusion", "diffusion"), ("total", "total"),
       ("update", "total"), ("adam_alone", "total"))
TERMS = ("sim", "gicon", "diffusion")


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------------
# the JAX side
# --------------------------------------------------------------------------


def jax_state(snap):
    """(params, opt_state) of optax.adam for a kept state."""
    import jax.numpy as jnp
    import optax

    params = {"u_ab": jnp.asarray(snap["u_ab"]), "u_ba": jnp.asarray(snap["u_ba"])}
    adam = optax.ScaleByAdamState(
        count=jnp.asarray(snap["count"], jnp.int32),
        mu={"u_ab": jnp.asarray(snap["m_ab"]), "u_ba": jnp.asarray(snap["m_ba"])},
        nu={"u_ab": jnp.asarray(snap["v_ab"]), "u_ba": jnp.asarray(snap["v_ba"])})
    return params, (adam, optax.EmptyState())


def keep(params, opt_state, base_ab, base_ba, a_s, b_s, lr) -> dict:
    """A JAX state on the host, in the form `handoff_point` takes."""
    adam = opt_state[0]
    out = {"a_s": a_s, "b_s": b_s, "base_ab": base_ab, "base_ba": base_ba, "u_ab": params["u_ab"],
           "u_ba": params["u_ba"], "m_ab": adam.mu["u_ab"], "m_ba": adam.mu["u_ba"], "v_ab": adam.nu["u_ab"],
           "v_ba": adam.nu["u_ba"]}
    out = {k: np.array(v, np.float32) for k, v in out.items()}
    out["count"], out["lr"] = int(adam.count), float(lr)
    return out


_JAX_FNS = {}


def jax_fns(shape_s, lr):
    """Jitted JAX functions for a scale: the weighted terms with their
    gradients, the summed loss's gradient written as `_scale_run_fn`'s
    loss_fn writes it, optax's update, and the package's own opt_step."""
    key = (tuple(shape_s), float(lr))
    if key in _JAX_FNS:
        return _JAX_FNS[key]
    import jax
    import jax.numpy as jnp
    import optax

    from oai_analysis_2_tpu.models import gradicon as JG

    ident_s = JG._identity_map_np(tuple(shape_s))
    sim_fn = JG.make_similarity(SIMILARITY, LNCC_WINDOW)

    def maps(p, base_ab, base_ba):
        return JG.compose(base_ab, ident_s + p["u_ab"]), JG.compose(base_ba, ident_s + p["u_ba"])

    def sim(p, base_ab, base_ba, a_s, b_s):
        pab, pba = maps(p, base_ab, base_ba)
        wb = JG.warp(b_s.astype(jnp.bfloat16), pab).astype(jnp.float32)
        wa = JG.warp(a_s.astype(jnp.bfloat16), pba).astype(jnp.float32)
        return sim_fn(a_s, wb) + sim_fn(b_s, wa)

    def gicon(p, base_ab, base_ba, a_s, b_s):
        return LAMBDA_REG * JG.gradicon_penalty_alternating(*maps(p, base_ab, base_ba))

    def diffusion(p, base_ab, base_ba, a_s, b_s):
        pab, pba = maps(p, base_ab, base_ba)
        return DIFFUSION_WEIGHT * (JG.diffusion_penalty(pab) + JG.diffusion_penalty(pba))

    def total(p, base_ab, base_ba, a_s, b_s):
        # gradicon.py:569-579, term for term
        pab, pba = maps(p, base_ab, base_ba)
        wb = JG.warp(b_s.astype(jnp.bfloat16), pab).astype(jnp.float32)
        wa = JG.warp(a_s.astype(jnp.bfloat16), pba).astype(jnp.float32)
        s = sim_fn(a_s, wb) + sim_fn(b_s, wa)
        reg = JG.gradicon_penalty_alternating(pab, pba)
        smooth = JG.diffusion_penalty(pab) + JG.diffusion_penalty(pba)
        return s + LAMBDA_REG * reg + DIFFUSION_WEIGHT * smooth

    optimizer = optax.adam(lr / float(max(shape_s)))
    _, opt_step = JG._scale_run_fn(tuple(shape_s), tuple(shape_s), 1, float(lr), LNCC_WINDOW, SIMILARITY,
                                   LAMBDA_REG, DIFFUSION_WEIGHT, "alternating", None)

    def update(g, opt_state, params):
        upd, _ = optimizer.update(g, opt_state, params)
        return optax.apply_updates(params, upd)

    fns = {name: jax.jit(jax.value_and_grad(f))
           for name, f in (("sim", sim), ("gicon", gicon), ("diffusion", diffusion), ("total", total))}
    fns["apply"] = jax.jit(update)
    fns["opt_step"] = jax.jit(opt_step)
    _JAX_FNS[key] = fns
    return fns


def jax_eval(snap, terms=TERMS) -> dict:
    """Each op's value in JAX at a kept state: the terms' values and
    gradients, the summed gradient, and u after the package's own
    `opt_step`; `replica_bit_equal` says whether optax's update on the
    summed gradient lands on opt_step's u bit for bit (XLA may fuse the two
    programs differently). `terms`: the terms evaluated beside the sum."""
    import jax.numpy as jnp

    fns = jax_fns(snap["a_s"].shape, snap["lr"])
    params, opt_state = jax_state(snap)
    args = tuple(jnp.asarray(snap[k]) for k in ("base_ab", "base_ba", "a_s", "b_s"))
    out = {"loss": {}, "grad": {}}
    for name in (*terms, "total"):
        value, g = fns[name](params, *args)
        out["loss"][name] = float(value)
        out["grad"][name] = [np.asarray(g["u_ab"]), np.asarray(g["u_ba"])]
    g = {"u_ab": jnp.asarray(out["grad"]["total"][0]), "u_ba": jnp.asarray(out["grad"]["total"][1])}
    replica = fns["apply"](g, opt_state, params)
    own, _, own_loss = fns["opt_step"](params, opt_state, *args)
    out["after"] = [np.asarray(own["u_ab"]), np.asarray(own["u_ba"])]
    out["replica_bit_equal"] = bool(all(np.array_equal(np.asarray(own[k]), np.asarray(replica[k]))
                                        for k in ("u_ab", "u_ba")) and float(own_loss) == out["loss"]["total"])
    return out


# --------------------------------------------------------------------------
# the port's side
# --------------------------------------------------------------------------


def port_problem(snap):
    """The port's `InstanceScale` in a kept JAX state, Adam's moments and
    step count included, on the CPU."""
    import torch

    from oai_analysis_2_tpu_torch.models import gradicon as TG

    t = {k: torch.tensor(snap[k]) for k in STATE_KEYS}
    p = TG.InstanceScale(t["base_ab"], t["base_ba"], t["a_s"], t["b_s"], lr=snap["lr"], lncc_window=LNCC_WINDOW,
                         similarity=SIMILARITY, lambda_reg=LAMBDA_REG, diffusion_weight=DIFFUSION_WEIGHT,
                         gicon_grad="alternating")
    with torch.no_grad():
        p.u_ab.copy_(t["u_ab"])
        p.u_ba.copy_(t["u_ba"])
    if snap["count"]:
        for u, side in ((p.u_ab, "ab"), (p.u_ba, "ba")):
            p.optimizer.state[u] = {"step": torch.tensor(float(snap["count"])), "exp_avg": t[f"m_{side}"].clone(),
                                    "exp_avg_sq": t[f"v_{side}"].clone()}
    return p


def port_adam(snap, grads):
    """u after the port's Adam step (`InstanceScale`'s optimizer) from the
    kept moments, on the gradients `grads` (numpy, u_ab then u_ba)."""
    import torch

    p = port_problem(snap)
    for u, g in zip((p.u_ab, p.u_ba), grads):
        u.grad = torch.tensor(np.asarray(g, np.float32))
    p.optimizer.step()
    return [p.u_ab.detach().numpy().copy(), p.u_ba.detach().numpy().copy()]


def port_eval(snap, jax_total=None, terms=TERMS) -> dict:
    """`jax_eval`'s ops in the port; with `jax_total`, also u after the
    port's Adam on JAX's summed gradient (`adam_alone`)."""
    import torch

    from oai_analysis_2_tpu_torch.models import gradicon as TG

    p = port_problem(snap)
    out = {"loss": {}, "grad": {}}
    with torch.enable_grad():
        pab, pba = p.maps()
        wb = TG.warp(p.b16, pab).float()
        wa = TG.warp(p.a16, pba).float()
        values = {"sim": lambda: p.sim(p.a_s, wb) + p.sim(p.b_s, wa),
                  "gicon": lambda: p.lambda_reg * p.penalty(pab, pba),
                  "diffusion": lambda: p.diffusion_weight * (TG.diffusion_penalty(pab) + TG.diffusion_penalty(pba))}
        values = {k: values[k]() for k in terms}
        for name, value in values.items():
            g = torch.autograd.grad(value, [p.u_ab, p.u_ba], retain_graph=True, allow_unused=True)
            out["loss"][name] = float(value.detach())
            out["grad"][name] = [np.zeros(snap["u_ab"].shape, np.float32) if x is None else x.numpy().copy()
                                 for x in g]
    # the summed gradient and step exactly as `InstanceScale.step` takes them
    loss = p.step()
    out["loss"]["total"] = float(loss)
    out["grad"]["total"] = [p.u_ab.grad.numpy().copy(), p.u_ba.grad.numpy().copy()]
    out["after"] = [p.u_ab.detach().numpy().copy(), p.u_ba.detach().numpy().copy()]
    if jax_total is not None:
        out["adam_alone"] = port_adam(snap, jax_total)
    return out


# --------------------------------------------------------------------------
# the comparison
# --------------------------------------------------------------------------


def ulp_state(snap, seed) -> dict:
    """`snap` with every element of every array moved by one f32 ulp, up or
    down at random (`default_rng(seed)`)."""
    rng = np.random.default_rng(seed)
    out = dict(snap)
    for k in STATE_KEYS:
        x = snap[k]
        toward = np.where(rng.integers(0, 2, x.shape) == 1, np.float32(np.inf), np.float32(-np.inf))
        out[k] = np.nextafter(x, toward).astype(np.float32)
    return out


def element_classes(g_ref, g_other) -> dict:
    """Masks of the three classes over u_ab and u_ba together."""
    g_ref = np.concatenate([np.ravel(v) for v in g_ref])
    g_other = np.concatenate([np.ravel(v) for v in g_other])
    zero_xor = (g_ref == 0) != (g_other == 0)
    top = float(np.abs(g_ref).max())
    large = ~zero_xor & (np.abs(g_ref) >= SMALL_SHARE * top) & (top > 0)
    return {"large": large, "small": ~zero_xor & ~large, "zero_xor": zero_xor}


def class_stats(ref, other, classes, unit=1.0) -> dict:
    """Per class: count, largest |other - ref|, signed mean and rms of
    (other - ref), and the share of elements whose signs disagree; in
    units of `unit`."""
    ref = np.concatenate([np.ravel(v) for v in ref]).astype(np.float64)
    other = np.concatenate([np.ravel(v) for v in other]).astype(np.float64)
    d = (other - ref) / unit
    out = {}
    for name, m in classes.items():
        n = int(m.sum())
        if n == 0:
            out[name] = {"n": 0, "max_gap": 0.0, "bias": 0.0, "rms": 0.0, "sign_disagree": 0.0}
            continue
        out[name] = {"n": n, "max_gap": float(np.abs(d[m]).max()), "bias": float(d[m].mean()),
                     "rms": float(np.sqrt(np.mean(d[m] ** 2))),
                     "sign_disagree": float(np.mean(np.sign(other[m]) != np.sign(ref[m])))}
    return out


def op_values(ev, op, snap):
    """(values, unit) of an op in an evaluation: gradients as they are, u's
    change in whole steps of lr / max(grid)."""
    if op in ("sim", "gicon", "diffusion", "total"):
        return ev["grad"][op], 1.0
    key = "after" if op == "update" else op
    return [a - u for a, u in zip(ev[key], (snap["u_ab"], snap["u_ba"]))], snap["lr"] / max(snap["a_s"].shape)


def compare(ref, other, snap) -> dict:
    """Every op of `other` against `ref` (JAX's evaluation), per class, and
    each loss term's gap."""
    out = {"loss": {k: other["loss"][k] - v for k, v in ref["loss"].items()}}
    for op, by in OPS:
        if op not in ref["grad"] and op != "update" and not (op == "adam_alone" and op in other):
            continue
        # the port's Adam alone steps on JAX's own gradient
        classes = element_classes(ref["grad"][by], ref["grad"][by] if op == "adam_alone" else other["grad"][by])
        r, unit = op_values(ref, "update" if op == "adam_alone" else op, snap)
        out[op] = class_stats(r, op_values(other, op, snap)[0], classes, unit)
    return out


def envelope_of(gaps: list) -> dict:
    """The rounding envelope over the perturbed JAX runs: per op and class
    the largest count, gap, |signed mean|, rms and sign share, and each
    loss term's largest gap."""
    env = {"loss": {k: max(abs(g["loss"][k]) for g in gaps) for k in gaps[0]["loss"]}}
    for op, _ in OPS:
        rows_of = [g["update" if op == "adam_alone" else op] for g in gaps]
        env[op] = {}
        for c in CLASSES:
            rows = [r[c] for r in rows_of]
            env[op][c] = {k: max(abs(r[k]) for r in rows) for k in ("n", "max_gap", "bias", "rms", "sign_disagree")}
    return env


def departures(port_gap: dict, env: dict, values: dict, n: int) -> list:
    """The (op, class, what) of `port_gap` beyond `DEPART` envelopes. A
    loss term's value is a mean over the `n` elements of u_ab and u_ba; its
    envelope is floored at sqrt(n) f32 epsilons of it, the rounding a
    change of summation order gives (the one-ulp move often leaves such a
    sum as it was)."""
    out = []
    for k, g in port_gap["loss"].items():
        floor = np.sqrt(n) * float(np.finfo(np.float32).eps) * abs(values[k])
        if abs(g) > DEPART * max(env["loss"][k], floor):
            out.append((f"loss.{k}", "-", "gap"))
    for op, _ in OPS:
        if op not in port_gap:
            continue
        for c in CLASSES:
            got = port_gap[op][c]
            if got["n"] == 0:
                continue
            e = env[op][c] if env[op][c]["n"] else env[op]["small"]
            if got["max_gap"] > DEPART * e["max_gap"]:
                out.append((op, c, "max_gap"))
            # a mean of n gaps scatters by rms / sqrt(n): the envelope's rms, or the op's own
            if abs(got["bias"]) > DEPART * max(e["bias"], max(e["rms"], got["rms"]) / np.sqrt(got["n"])):
                out.append((op, c, "bias"))
    return out


def handoff_point(snap, envelope_seeds=(1, 2)) -> dict:
    """JAX and the port at one kept state, the port's gaps and the
    envelope's, and the ops that depart."""
    ref = jax_eval(snap)
    port = port_eval(snap, ref["grad"]["total"])
    env_gaps = [compare(ref, jax_eval(ulp_state(snap, s)), snap) for s in envelope_seeds]
    port_gap = compare(ref, port, snap)
    env = envelope_of(env_gaps)
    return {"count": snap["count"], "loss": ref["loss"], "jax_replica_bit_equal": ref["replica_bit_equal"],
            "port": port_gap, "envelope": env,
            "departs": [list(d) for d in departures(port_gap, env, ref["loss"], 2 * snap["u_ab"].size)]}


# --------------------------------------------------------------------------
# the JAX trajectory
# --------------------------------------------------------------------------


def stepwise_instance(points, kept):
    """A stand-in for JAX's `register_pair_instance` (gradicon.py:429-517,
    without early stop or an initial map) that runs each scale one jitted
    `opt_step` at a time and keeps the state before each (scale, step) of
    `points` in `kept`."""
    import jax
    import jax.numpy as jnp
    import optax

    from oai_analysis_2_tpu.models import gradicon as JG

    def run(a, b, scales=(8, 4, 2), steps_per_scale=60, lr=JG.INSTANCE_DEFAULT_LR, lncc_window=5,
            lambda_reg=0.5, diffusion_weight=0.3, similarity=JG.INSTANCE_DEFAULT_SIMILARITY, verbose=False,
            init_ab=None, init_ba=None, gicon_grad=JG.INSTANCE_DEFAULT_GICON_GRAD, early_stop=None):
        if early_stop is not None or init_ab is not None or init_ba is not None:
            raise ValueError("stepwise_instance: instance mode from the identity, fixed step counts only")
        if (lncc_window, lambda_reg, diffusion_weight, similarity, gicon_grad) != \
                (LNCC_WINDOW, LAMBDA_REG, DIFFUSION_WEIGHT, SIMILARITY, "alternating"):
            raise ValueError("stepwise_instance: the validator's instance loss only")
        if isinstance(steps_per_scale, int):
            steps_per_scale = [steps_per_scale] * len(scales)
        full_shape = a.shape
        phi_ab = phi_ba = JG.identity_map(full_shape)
        for scale, n_steps in zip(scales, steps_per_scale):
            a_s, b_s = a, b
            for _ in range(int.bit_length(int(scale)) - 1):
                a_s, b_s = JG.downsample2x(a_s), JG.downsample2x(b_s)
            shape_s = a_s.shape
            base_ab, base_ba = JG.resize_field(phi_ab, shape_s), JG.resize_field(phi_ba, shape_s)
            _, opt_step = JG._scale_run_fn(shape_s, full_shape, int(n_steps), float(lr), lncc_window, similarity,
                                           lambda_reg, diffusion_weight, gicon_grad, None)
            step = jax.jit(opt_step)
            u0 = jnp.zeros(shape_s + (3,), jnp.float32)
            params = {"u_ab": u0, "u_ba": u0}
            opt_state = optax.adam(lr / float(max(shape_s))).init(params)
            for i in range(int(n_steps)):
                if (int(scale), i) in points:
                    kept[int(scale), i] = keep(params, opt_state, base_ab, base_ba, a_s, b_s, lr)
                params, opt_state, _ = step(params, opt_state, base_ab, base_ba, a_s, b_s)
            ident_s = JG._identity_map_np(shape_s)
            phi_ab, phi_ba = _finish(ident_s, full_shape)(params, base_ab, base_ba)
        return phi_ab, phi_ba

    return run


def _finish(ident_s, full_shape):
    """`_scale_run_fn`'s `_finish`, jitted on its own."""
    import jax

    from oai_analysis_2_tpu.models import gradicon as JG

    @jax.jit
    def finish(params, base_ab, base_ba):
        return (JG.resize_field(JG.compose(base_ab, ident_s + params["u_ab"]), full_shape),
                JG.resize_field(JG.compose(base_ba, ident_s + params["u_ba"]), full_shape))

    return finish


def jax_validator(argv, instance) -> tuple:
    """The JAX script's run with `oai_analysis_2_tpu.engine.registration`'s
    `register_pair_instance` replaced by `instance` (None: its own), and
    the maps it returned."""
    import oai_analysis_2_tpu.engine.registration as jreg

    spread = _load_tool("port_instance_spread")
    own = jreg.register_pair_instance
    got = {}

    def recording(*args, **kwargs):
        got["maps"] = tuple(np.asarray(m) for m in (instance or own)(*args, **kwargs))
        return got["maps"]

    jreg.register_pair_instance = recording
    try:
        run = spread.jax_run(list(argv), None)
    finally:
        jreg.register_pair_instance = own
    return run, got["maps"]


def parse_points(spec) -> set:
    return {(int(scale), int(s)) for part in spec.split(";") if part for scale, steps in [part.split(":")]
            for s in steps.split(",")}


def _fmt(x):
    return f"{x:.3g}"


def print_point(name, h):
    print(f"{name} (Adam count {h['count']}; JAX's replica of opt_step bit-equal: {h['jax_replica_bit_equal']})")
    for k, g in h["port"]["loss"].items():
        print(f"  loss.{k:9s} JAX {h['loss'][k]:.8g}  port-JAX {_fmt(g)}  envelope {_fmt(h['envelope']['loss'][k])}")
    for op, _ in OPS:
        if op not in h["port"]:
            continue
        cells = []
        for c in CLASSES:
            p, e = h["port"][op][c], h["envelope"][op][c]
            cells.append(f"{c} n {p['n']}/{e['n']} gap {_fmt(p['max_gap'])}/{_fmt(e['max_gap'])} "
                         f"bias {_fmt(p['bias'])}/{_fmt(e['bias'])} sign {_fmt(p['sign_disagree'])}/"
                         f"{_fmt(e['sign_disagree'])}")
        print(f"  {op:10s} " + " | ".join(cells))
    print(f"  departs: {h['departs'] or 'none'}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--points", default=DEFAULT_POINTS, help="scale:step,step;... kept and handed to the port")
    ap.add_argument("--envelope-seeds", default="1,2")
    ap.add_argument("--out", default=str(ROOT / "build" / "instance_handoff.json"))
    ap.add_argument("validator", nargs="*", help="arguments for the JAX script (after --)")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    torch.set_num_threads(a.threads)
    points = parse_points(a.points)
    jitted, jitted_maps = jax_validator(a.validator, None)
    kept = {}
    stepped, stepped_maps = jax_validator(a.validator, stepwise_instance(points, kept))
    missing = sorted(points - set(kept))
    if missing:
        raise SystemExit(f"port_instance_handoff: no state at {missing} (scale, step)")
    repro = {"err_mean_mm_jitted": jitted["err_mean_mm"], "err_mean_mm_stepwise": stepped["err_mean_mm"],
             "err_mean_gap_mm": stepped["err_mean_mm"] - jitted["err_mean_mm"],
             "maps_max_abs_gap": max(float(np.abs(s - j).max()) for s, j in zip(stepped_maps, jitted_maps))}
    print(f"JAX stepwise against its fori_loop: mean field error {repro['err_mean_mm_stepwise']:.6f} against "
          f"{repro['err_mean_mm_jitted']:.6f} mm (gap {repro['err_mean_gap_mm']:.3g}); maps' largest gap "
          f"{repro['maps_max_abs_gap']:.3g}", flush=True)
    seeds = tuple(int(s) for s in a.envelope_seeds.split(","))
    points_out, first = {}, None
    for scale, step in sorted(kept, key=lambda k: (-k[0], k[1])):
        name = f"scale{scale}@{step}"
        h = handoff_point(kept[scale, step], seeds)
        points_out[name] = h
        print_point(name, h)
        sys.stdout.flush()
        if first is None and h["departs"]:
            first = {"point": name, "op": h["departs"][0]}
    report = {"validator_args": a.validator, "threads": a.threads, "envelope_seeds": list(seeds),
              "reproduction": repro, "points": points_out, "first_departure": first}
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(report, indent=1))
    print("first op that departs: " + (f"{first['op']} at {first['point']}" if first else "none departs"))
    return report


if __name__ == "__main__":
    main()
