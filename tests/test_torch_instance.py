"""The PyTorch port's losses and instance optimization against the JAX
package (`oai_analysis_2_tpu/models/gradicon.py:111-246, :418-723`).

Both packages see the same seeded numpy inputs on the CPU. Values and
gradients agree to f32 rounding; whole runs of Adam do not stay bit-close
(a first Adam step is about lr * sign(g), so an element whose gradient is
rounding noise moves a whole step either way), so runs are held to map and
quality tolerances stated per test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from oai_analysis_2_tpu.models import gradicon as JG
from oai_analysis_2_tpu_torch.models import gradicon as TG
from oai_analysis_2_tpu_torch.ops import resample as TR

torch.set_num_threads(2)

SHAPE = (8, 12, 12)


def _blob(shape, center, sigma=3.0):
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (zz - center[0]) ** 2 + (yy - center[1]) ** 2 + (xx - center[2]) ** 2
    return np.exp(-d2 / (2 * sigma**2)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    a = _blob(SHAPE, (4, 6, 6)) + 0.1 * rng.uniform(size=SHAPE).astype(np.float32)
    b = _blob(SHAPE, (4, 6, 8)) + 0.1 * rng.uniform(size=SHAPE).astype(np.float32)
    return a, b


def _smooth_maps(shape, seed):
    rng = np.random.default_rng(seed)
    ident = np.asarray(JG.identity_map(shape))
    coarse = rng.normal(0, 0.03, (3, 4, 4, 3)).astype(np.float32)
    pert = np.asarray(JG.resize_field(jnp.asarray(coarse), shape))
    return (ident + pert).astype(np.float32), (ident - pert).astype(np.float32)


@pytest.mark.parametrize("win", [3, 5])
def test_lncc_matches(win):
    """LNCC over random volumes with a constant block (zero variance there);
    within 1e-6."""
    rng = np.random.default_rng(win)
    a = rng.uniform(0, 1, SHAPE).astype(np.float32)
    b = (0.5 * a + rng.uniform(0, 0.5, SHAPE)).astype(np.float32)
    a[:4, :6, :6] = 0.25
    b[:4, :6, :6] = 0.75
    want = float(JG.lncc(jnp.asarray(a), jnp.asarray(b), win))
    got = float(TG.lncc(torch.tensor(a), torch.tensor(b), win))
    assert abs(got - want) <= 1e-6, (got, want)
    box_want = np.asarray(JG._box_mean(jnp.asarray(a), win))
    np.testing.assert_allclose(TG._box_mean(torch.tensor(a), win).numpy(), box_want, atol=1e-6)


@pytest.mark.parametrize("kind", ["lncc", "lncc+mse", "mse"])
def test_similarity_matches(pair, kind):
    a, b = pair
    want = float(JG.make_similarity(kind, 5, 10.0)(jnp.asarray(a), jnp.asarray(b)))
    got = float(TG.make_similarity(kind, 5, 10.0)(torch.tensor(a), torch.tensor(b)))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("name", ["gradicon_penalty", "gradicon_penalty_alternating", "diffusion_penalty"])
def test_penalties_match(name):
    """Relative 1e-5 on smooth random maps (the finite differences divide by
    grid steps of 1/7 to 1/11)."""
    phi_ab, phi_ba = _smooth_maps(SHAPE, 4)
    args = (phi_ab,) if name == "diffusion_penalty" else (phi_ab, phi_ba)
    want = float(getattr(JG, name)(*(jnp.asarray(v) for v in args)))
    got = float(getattr(TG, name)(*(torch.tensor(v) for v in args)))
    assert want > 1e-3
    assert abs(got - want) <= 1e-5 * want, (got, want)


def _jax_loss(gicon_grad):
    """The instance loss (gradicon.py:569-579) written with the JAX
    package's public functions."""
    ident_s = JG._identity_map_np(SHAPE)
    sim_fn = JG.make_similarity("lncc+mse", 5)
    penalty = JG.gradicon_penalty if gicon_grad == "exact" else JG.gradicon_penalty_alternating

    def loss(p, base_ab, base_ba, a_s, b_s):
        pab = JG.compose(base_ab, ident_s + p["u_ab"])
        pba = JG.compose(base_ba, ident_s + p["u_ba"])
        wb = JG.warp(b_s.astype(jnp.bfloat16), pab).astype(jnp.float32)
        wa = JG.warp(a_s.astype(jnp.bfloat16), pba).astype(jnp.float32)
        sim = sim_fn(a_s, wb) + sim_fn(b_s, wa)
        smooth = JG.diffusion_penalty(pab) + JG.diffusion_penalty(pba)
        return sim + 0.5 * penalty(pab, pba) + 0.3 * smooth

    return loss


def _state(name):
    """(base_ab, base_ba, u_ab, u_ba): "identity" is u = 0 on the identity
    base, where sample points land exactly on grid nodes (the clip ties);
    "smooth" is a smooth random state away from them."""
    ident = np.asarray(JG.identity_map(SHAPE))
    if name == "identity":
        zero = np.zeros(SHAPE + (3,), np.float32)
        return ident, ident, zero, zero
    base_ab, base_ba = _smooth_maps(SHAPE, 5)
    u_ab, u_ba = (m - ident for m in _smooth_maps(SHAPE, 6))
    return base_ab, base_ba, 0.5 * u_ab, -0.5 * u_ba


def _gradients(pair, state, gicon_grad):
    a, b = pair
    base_ab, base_ba, u_ab, u_ba = _state(state)
    params = {"u_ab": jnp.asarray(u_ab), "u_ba": jnp.asarray(u_ba)}
    want_l, want_g = jax.value_and_grad(_jax_loss(gicon_grad))(
        params, jnp.asarray(base_ab), jnp.asarray(base_ba), jnp.asarray(a), jnp.asarray(b))
    prob = TG.InstanceScale(torch.tensor(base_ab), torch.tensor(base_ba), torch.tensor(a), torch.tensor(b),
                            gicon_grad=gicon_grad)
    with torch.no_grad():
        prob.u_ab.copy_(torch.tensor(u_ab))
        prob.u_ba.copy_(torch.tensor(u_ba))
    got_l = prob.loss()
    got_l.backward()
    return (float(want_l), float(got_l),
            {k: np.asarray(v) for k, v in want_g.items()},
            {"u_ab": prob.u_ab.grad.numpy(), "u_ba": prob.u_ba.grad.numpy()})


@pytest.mark.parametrize("gicon_grad", ["alternating", "exact"])
@pytest.mark.parametrize("state", ["identity", "smooth"])
def test_gradients_match(pair, state, gicon_grad):
    """jax.grad of the instance loss against the port's autograd, within
    1e-6 absolute (the largest gradients are 0.02-0.09), loss within 1e-5
    relative. At "identity" this holds only with the tie-halving clip."""
    want_l, got_l, want_g, got_g = _gradients(pair, state, gicon_grad)
    assert abs(got_l - want_l) <= 1e-5 * abs(want_l)
    for k in want_g:
        assert np.abs(want_g[k]).max() > 1e-2
        np.testing.assert_allclose(got_g[k], want_g[k], atol=1e-6, rtol=0, err_msg=k)


def test_clamp_gradient_fails_at_the_ties(pair, monkeypatch):
    """With torch.clamp's gradient (all of it at a tie) in place of the
    tie-halving clip, the u = 0 gradient disagrees with JAX's on most
    elements, by more than the largest gradient."""
    clamp = lambda x, lo, hi: torch.clamp(x, lo, hi)  # noqa: E731
    monkeypatch.setattr(TR, "clip_ties", clamp)
    monkeypatch.setattr(TG, "clip_ties", clamp)
    _, _, want_g, got_g = _gradients(pair, "identity", "alternating")
    diff = np.abs(got_g["u_ab"] - want_g["u_ab"])
    assert (diff > 1e-6).mean() > 0.5
    assert diff.max() > np.abs(want_g["u_ab"]).max()


def test_clip_ties_gradient():
    x = torch.tensor([-0.5, 0.0, 0.25, 1.0, 1.5], requires_grad=True)
    TR.clip_ties(x, 0.0, 1.0).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [0.0, 0.5, 1.0, 0.5, 0.0])
    want = jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("gicon_grad", ["alternating", "exact"])
def test_one_adam_step_matches(pair, gicon_grad):
    """One step from u = 0 on the identity base against JAX's own opt_step
    (`_scale_run_fn(...)[1]`, optax.adam). The step is lr * g / (|g| + eps),
    about lr * sign(g): elements whose JAX gradient is under 1e-4 of the
    largest are held apart (their sign is rounding), and must only stay
    within one step; every other element agrees within 1e-4 of a step."""
    a, b = pair
    lr = 1.2
    lr_norm = lr / max(SHAPE)
    _, opt_step = JG._scale_run_fn(SHAPE, SHAPE, 1, lr, 5, "lncc+mse", 0.5, 0.3, gicon_grad, None)
    ident = JG.identity_map(SHAPE)
    zero = jnp.zeros(SHAPE + (3,), jnp.float32)
    params = {"u_ab": zero, "u_ba": zero}
    new, _, want_l = opt_step(params, optax.adam(lr_norm).init(params), ident, ident,
                              jnp.asarray(a), jnp.asarray(b))
    _, _, want_g, _ = _gradients(pair, "identity", gicon_grad)

    prob = TG.InstanceScale(TG.identity_map(SHAPE), TG.identity_map(SHAPE), torch.tensor(a), torch.tensor(b),
                            lr=lr, gicon_grad=gicon_grad)
    got_l = float(prob.step())
    assert abs(got_l - float(want_l)) <= 1e-5 * abs(float(want_l))
    for k, got in (("u_ab", prob.u_ab), ("u_ba", prob.u_ba)):
        got, want, g = got.detach().numpy(), np.asarray(new[k]), want_g[k]
        small = np.abs(g) < 1e-4 * np.abs(g).max()
        assert small.mean() < 0.25, small.mean()
        np.testing.assert_allclose(got[~small], want[~small], atol=1e-4 * lr_norm, rtol=0)
        assert np.abs(got[small]).max() <= lr_norm * (1 + 1e-5)


@pytest.mark.parametrize("gicon_grad", ["alternating", "exact"])
def test_few_scale_run_matches(gicon_grad):
    """register_pair_instance, grid 12x16x16, scales (2, 1), 10 steps each,
    at the fine-tune lr 0.15: the maps within 2e-3 on average and within
    four scale-1 steps (4 x 0.15 / 16) everywhere; inverse consistency
    within 0.01 voxel (mean) and 0.1 voxel (max); fold fractions within
    0.005."""
    shape = (12, 16, 16)
    rng = np.random.default_rng(0)
    a = _blob(shape, (6, 8, 8)) + 0.05 * rng.uniform(size=shape).astype(np.float32)
    b = _blob(shape, (6, 8, 9)) + 0.05 * rng.uniform(size=shape).astype(np.float32)
    kw = dict(scales=(2, 1), steps_per_scale=10, lr=0.15, gicon_grad=gicon_grad)
    jab, jba = JG.register_pair_instance(jnp.asarray(a), jnp.asarray(b), **kw)
    tab, tba = TG.register_pair_instance(torch.tensor(a), torch.tensor(b), **kw)
    for got, want in ((tab, jab), (tba, jba)):
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.mean() <= 2e-3 and diff.max() <= 4 * 0.15 / 16, (diff.mean(), diff.max())
    jq, tq = JG.map_quality_stats(jab, jba), TG.map_quality_stats(tab, tba)
    assert abs(float(tq["ice_mean_vox"]) - float(jq["ice_mean_vox"])) <= 0.01
    assert abs(float(tq["ice_max_vox"]) - float(jq["ice_max_vox"])) <= 0.1
    for k in ("fold_fraction_ab", "fold_fraction_ba"):
        assert abs(float(tq[k]) - float(jq[k])) <= 0.005, k


def test_recovers_translation():
    """Mirror of tests/test_registration.py:113-123 on the port."""
    shape = (16, 32, 32)
    a = _blob(shape, (8, 16, 16), sigma=4.0)
    b = _blob(shape, (8, 16, 20), sigma=4.0)
    before = float(np.mean((a - b) ** 2))
    phi_ab, _ = TG.register_pair_instance(torch.tensor(a), torch.tensor(b), scales=(4, 2), steps_per_scale=40)
    after = float(torch.mean((torch.tensor(a) - TG.warp(torch.tensor(b), phi_ab)) ** 2))
    assert after < 0.3 * before


@pytest.mark.parametrize("early_stop", [0.05, 0.2])
def test_early_stop_takes_jax_step_count(early_stop):
    """The plateau stop at scale 2 of an easy translation (as
    tests/test_registration.py:125-157) takes exactly the steps JAX's
    bounded while_loop takes, well under the 200-step cap."""
    shape = (16, 32, 32)
    a = _blob(shape, (8, 16, 16), sigma=4.0)
    b = _blob(shape, (8, 16, 20), sigma=4.0)
    runner = JG._scale_runner((8, 16, 16), shape, 200, 1.2, 5, "lncc+mse", 0.5, 0.3, False,
                              "alternating", early_stop)
    ident = JG.identity_map((8, 16, 16))
    _, _, want = runner(ident, ident, JG.downsample2x(jnp.asarray(a)), JG.downsample2x(jnp.asarray(b)))
    t_ident = TG.identity_map((8, 16, 16))
    prob = TG.InstanceScale(t_ident, t_ident, TG.downsample2x(torch.tensor(a)), TG.downsample2x(torch.tensor(b)))
    got = TG.run_scale(prob, 200, early_stop=early_stop)
    assert 6 < got < 200
    assert got == int(want)


def test_bad_gicon_mode_raises():
    a = torch.zeros((8, 8, 8))
    with pytest.raises(ValueError, match="gicon_grad"):
        TG.register_pair_instance(a, a, scales=(2,), steps_per_scale=1, gicon_grad="bogus")


def test_identity_maps_round_as_jax():
    for shape in [(8, 12, 16), (48, 96, 96)]:
        np.testing.assert_array_equal(TG.identity_map(shape).numpy(), np.asarray(JG.identity_map(shape)))
        np.testing.assert_array_equal(TG.identity_map_np(shape).numpy(), JG._identity_map_np(shape))
