"""`tools/port_instance_handoff.py`: JAX's own instance trajectory handed
to the port's `InstanceScale` past the loss's blow-up, where lr 1.2 has
pushed samples out of the unit cube, and each op held against JAX's.

The state is that of five steps of JAX's `opt_step`
(`_scale_run_fn(...)[1]`) at lr 1.2 from the identity on a 16x32x32 pair of
blobs (the loss rises from 1.95 to 19.2 at the second step; 5.8 % of the
sample points lie outside the unit cube at the fifth). The tolerances
were measured first (the port's largest gap here, beside it that of the
parent, whose optimizer was `torch.optim.Adam`), in whole steps of
lr / 32 for the updates:

- summed gradient, `large` class (|g| at least 1e-4 of the largest,
  0.093): 3.4e-7 absolute; `small`: 5.8e-8; `zero_xor` (exactly 0 in one
  package only): no element;
- the port's Adam alone on JAX's gradient: 4.0e-7 (parent 4.4e-6) at
  most, rms 3.1e-8 (parent 1.6e-6);
- the port's whole step on its own gradient, `small` class: rms 6.6e-8
  (parent 1.25e-6), signed mean 1e-10 (parent -2.9e-7).

So the Adam step holds within 1e-6 of a step (rms 1e-7), and the small
class of the whole step within rms 3e-7 and a signed mean of 3e-8: the
parent's Adam fails all three.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from oai_analysis_2_tpu.models import gradicon as JG
from oai_analysis_2_tpu_torch.utils import optim as TO

ROOT = Path(__file__).resolve().parents[1]
SHAPE, LR, STEPS = (16, 32, 32), 1.2, 5


def load_tool():
    spec = importlib.util.spec_from_file_location("port_instance_handoff",
                                                  ROOT / "tools" / "port_instance_handoff.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _blob(shape, center, sigma=4.0):
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (zz - center[0]) ** 2 + (yy - center[1]) ** 2 + (xx - center[2]) ** 2
    return np.exp(-d2 / (2 * sigma**2)).astype(np.float32)


@pytest.fixture(scope="module")
def handed():
    """(tool, JAX's state after STEPS of its own opt_step, JAX's ops there,
    the port's, and the port's gaps)."""
    tool = load_tool()
    rng = np.random.default_rng(0)
    a = jnp.asarray(_blob(SHAPE, (8, 16, 16)) + 0.05 * rng.uniform(size=SHAPE).astype(np.float32))
    b = jnp.asarray(_blob(SHAPE, (8, 16, 20)) + 0.05 * rng.uniform(size=SHAPE).astype(np.float32))
    _, opt_step = JG._scale_run_fn(SHAPE, SHAPE, 1, LR, 5, "lncc+mse", 0.5, 0.3, "alternating", None)
    step = jax.jit(opt_step)
    ident = JG.identity_map(SHAPE)
    zero = jnp.zeros(SHAPE + (3,), jnp.float32)
    params = {"u_ab": zero, "u_ba": zero}
    state = optax.adam(LR / max(SHAPE)).init(params)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, ident, ident, a, b)
        losses.append(float(loss))
    snap = tool.keep(params, state, ident, ident, a, b, LR)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ref = tool.jax_eval(snap, terms=())
        port = tool.port_eval(snap, ref["grad"]["total"], terms=())
    finally:
        torch.set_num_threads(threads)
    return tool, snap, losses, ref, port, tool.compare(ref, port, snap)


def test_state_is_past_the_blow_up(handed):
    _, snap, losses, _, _, _ = handed
    assert losses[1] > 5 * losses[0]
    pts = JG._identity_map_np(SHAPE) + np.stack([snap["u_ab"], snap["u_ba"]])
    assert np.mean((pts < 0) | (pts > 1)) > 0.01
    assert snap["count"] == STEPS


def test_loss_and_summed_gradient_match(handed):
    _, _, _, ref, port, gap = handed
    top = max(float(np.abs(g).max()) for g in ref["grad"]["total"])
    for k, v in ref["loss"].items():
        assert abs(port["loss"][k] - v) <= 1e-5 * abs(v), k
    assert gap["total"]["large"]["n"] > 0.8 * sum(g.size for g in ref["grad"]["total"])
    assert gap["total"]["large"]["max_gap"] <= 1e-5 * top
    assert gap["total"]["small"]["max_gap"] <= 2e-6 * top
    assert gap["total"]["zero_xor"]["n"] <= 10
    assert gap["total"]["zero_xor"]["max_gap"] <= 2e-6 * top


def test_adam_step_on_jax_gradient_matches_optax(handed):
    """The port's Adam alone on JAX's summed gradient: within 1e-6 of a
    step of optax's, rms 1e-7, in every class (the parent's
    `torch.optim.Adam`: 4.4e-6, rms 1.6e-6)."""
    _, _, _, _, _, gap = handed
    for c in ("large", "small"):
        assert gap["adam_alone"][c]["max_gap"] <= 1e-6, (c, gap["adam_alone"][c])
        assert gap["adam_alone"][c]["rms"] <= 1e-7, (c, gap["adam_alone"][c])


def test_whole_step_matches(handed):
    """The port's step on its own gradient against JAX's opt_step: every
    element within 1e-4 of a step; the small-gradient class unbiased (rms
    3e-7, signed mean 3e-8 of a step; the parent's 1.25e-6 and -2.9e-7)."""
    _, _, _, _, _, gap = handed
    for c in ("large", "small", "zero_xor"):
        assert gap["update"][c]["max_gap"] <= 1e-4, (c, gap["update"][c])
    assert gap["update"]["small"]["rms"] <= 3e-7, gap["update"]["small"]
    assert abs(gap["update"]["small"]["bias"]) <= 3e-8, gap["update"]["small"]


@pytest.mark.parametrize("count", [0, 1, 4, 39, 79])
def test_bias_correction_rounds_as_xla(count):
    """`bias_correction` is XLA's f32 `1 - decay**count` bit for bit."""
    for decay in (0.9, 0.999):
        want = np.asarray(jax.jit(lambda c: 1 - decay**c)(jnp.int32(count + 1)))
        assert TO.bias_correction(decay, count + 1) == float(want)


def test_adam_matches_optax_on_random_moments():
    """`utils.optim.Adam` against optax.adam at counts 0, 3 and 10 on
    random gradients and moments over 12 decades, from parameters at 0 (so
    the new parameters are the updates): measured 67-68 % of the updates
    bit for bit, the median relative gap 0, its mean 3e-10 at most and 99.9
    % of the gaps within 2.3e-7 (`torch.optim.Adam`: none bit for bit, the
    median 1.8e-7 to 3.0e-7, the mean 2.6e-8 to 4.1e-8, the 99.9th
    percentile 7.2e-6 to 1.0e-5). Held to 50 %, 0, 3e-9 and 1e-6."""
    rng = np.random.default_rng(1)
    n = 20000
    g = (rng.standard_normal(n) * 10.0 ** rng.uniform(-12, 0, n)).astype(np.float32)
    m = (rng.standard_normal(n) * 10.0 ** rng.uniform(-12, 0, n)).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 10.0 ** rng.uniform(-24, 0, n)).astype(np.float32)
    p = np.zeros(n, np.float32)
    lr = 0.0125
    opt = optax.adam(lr)
    # jitted, as opt_step runs it (XLA fuses the moments' updates into FMAs)
    step = jax.jit(lambda g, state, p: optax.apply_updates(p, opt.update(g, state, p)[0]))
    for count in (0, 3, 10):
        state = (optax.ScaleByAdamState(count=jnp.int32(count), mu=jnp.asarray(m), nu=jnp.asarray(v)),
                 optax.EmptyState())
        want = np.asarray(step(jnp.asarray(g), state, jnp.asarray(p)))
        q = torch.tensor(p).requires_grad_(True)
        adam = TO.Adam([q], lr=lr)
        adam.state[q] = {"step": torch.tensor(float(count)), "exp_avg": torch.tensor(m),
                         "exp_avg_sq": torch.tensor(v)}
        q.grad = torch.tensor(g)
        adam.step()
        got = q.detach().numpy()
        rel = (got.astype(np.float64) - want) / np.abs(want)
        assert np.mean(got == want) >= 0.5, count
        assert np.median(rel) == 0.0 and abs(np.mean(rel)) <= 3e-9, (count, np.median(rel), np.mean(rel))
        assert np.percentile(np.abs(rel), 99.9) <= 1e-6, count
