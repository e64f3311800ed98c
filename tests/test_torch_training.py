"""The port's segmentation training against the JAX package on the CPU.

The same numpy inputs and the same carried parameters go through
`engine/training.py`, the UNet's train-mode batch norm, its init and the
patch sampler of both packages. JAX runs on the CPU with XLA's conv; the
port takes its plain conv (what the kernel wrappers run for CPU tensors)
under autograd. Tolerances: losses 1e-5 relative, gradients 1e-4 of each
leaf's largest (f32 sums in another order), Adam-updated parameters 1e-6
absolute (lr 1e-3) on the elements whose gradient is above 1e-3 of the
leaf's largest (Adam moves a near-zero gradient by about +-lr whatever
its size, so its sign decides the update); sampler batches bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oai_analysis_2_tpu.engine import sampling as JS
from oai_analysis_2_tpu.engine import training as JT
from oai_analysis_2_tpu.models import unet3d as JU
from oai_analysis_2_tpu_torch.engine import sampling as TS
from oai_analysis_2_tpu_torch.engine import training as TT
from oai_analysis_2_tpu_torch.models import unet3d as TU
from oai_analysis_2_tpu_torch.utils import optim
from oai_analysis_2_tpu_torch.utils.checkpoint import carry_params, export_params, flatten_tree

torch.set_num_threads(2)

SHAPE = (2, 4, 8, 8)  # N, D, H, W of the UNet_light4 steps
LR = 1e-3


def _spec(batchnorm=False, bias=True):
    return JU.NETWORK_SPECS["UNet_light4"].replace(bias=bias, batchnorm=batchnorm)


def _tspec(batchnorm=False, bias=True):
    return TU.NETWORK_SPECS["UNet_light4"].replace(bias=bias, batchnorm=batchnorm)


def _params(batchnorm=False, seed=0):
    """JAX's init as numpy, with random BN statistics and biases so that
    every leaf carries a gradient."""
    tree = jax.tree.map(np.asarray, JU.UNet3D(_spec(batchnorm)).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    flat = flatten_tree(tree)
    for k, v in flat.items():
        if k.endswith("bias"):
            flat[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k.endswith("mean"):
            flat[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        elif k.endswith("var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.array(v, np.float32)
    return out


def _batch(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, shape + (1,)).astype(np.float32)
    labels = (rng.uniform(0, 1, shape + (2,)) > 0.6).astype(np.float32)
    return images, labels


def _port(params, batchnorm=False):
    model = TU.UNet3D(_tspec(batchnorm), device="cpu")
    carry_params(model, params)
    return model


def _close_rel(got: dict, want: dict, tol: float):
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, atol=tol, rtol=0, err_msg=k)


def _port_grads(model, images, labels, loss_fn=TT.dice_bce_loss):
    for p in model.parameters():
        p.requires_grad_(True)
        p.grad = None
    loss = loss_fn(model(torch.tensor(images)), torch.tensor(labels))
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    for p in model.parameters():
        p.requires_grad_(False)
    return float(loss.detach()), {k.replace(".", "/"): v for k, v in grads.items()}


@pytest.mark.parametrize("weighted", [False, True])
def test_dice_bce_matches_jax(weighted):
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (2, 3, 4, 5, 2)).astype(np.float32)
    labels = (rng.uniform(0, 1, logits.shape) > 0.5).astype(np.float32)
    w = np.asarray([0.3, 1.7], np.float32) if weighted else None
    want = float(JT.dice_bce_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  None if w is None else jnp.asarray(w)))
    got = float(TT.dice_bce_loss(torch.tensor(logits), torch.tensor(labels),
                                 None if w is None else torch.tensor(w)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("batchnorm", [False, True])
def test_train_step_matches_jax(batchnorm):
    """The loss and every leaf's gradient of one step (on a BN spec the
    running mean and var too: JAX differentiates the whole tree), then 3
    Adam steps of `make_train_step` from the same carried params."""
    params = _params(batchnorm)
    images, labels = _batch()
    jmodel = JU.UNet3D(_spec(batchnorm))
    jloss, jgrads = jax.value_and_grad(lambda p: JT.dice_bce_loss(jmodel.apply(p, jnp.asarray(images)),
                                                                  jnp.asarray(labels)))(params)
    jgrads = {k: np.asarray(v) for k, v in flatten_tree(jax.tree.map(np.asarray, jgrads)).items()}
    model = _port(params, batchnorm)
    tloss, tgrads = _port_grads(model, images, labels)
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-5)
    assert set(tgrads) == set(jgrads)
    if batchnorm:
        assert any(k.endswith("bn/mean") for k in tgrads)
        for k in tgrads:
            if k.endswith(("bn/mean", "bn/var")):
                assert np.abs(jgrads[k]).max() > 1e-6, k
    _close_rel(tgrads, jgrads, 1e-4)

    # 3 Adam steps on three batches
    opt = optax.adam(LR)
    jstep = JT.make_train_step(jmodel, opt)
    jp, jstate = jax.tree.map(jnp.asarray, params), opt.init(params)
    tstep = TT.make_train_step(model, optim.adam(list(model.parameters()), LR))
    assert all(p.requires_grad for p in model.parameters())
    for i in range(3):
        images, labels = _batch(seed=10 + i)
        jp, jstate, jl = jstep(jp, jstate, jnp.asarray(images), jnp.asarray(labels))
        tl = tstep(images, labels)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jflat = flatten_tree(jax.tree.map(np.asarray, jp))
    tflat = flatten_tree(export_params(model))
    for k, g in jgrads.items():
        mask = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(tflat[k][mask], jflat[k][mask], atol=1e-6, rtol=0, err_msg=k)


def test_bn_train_statistics_match_jax():
    """forward(train=True) on a BN spec: batch-statistics normalization and
    the running statistics with momentum 0.1 and the unbiased variance."""
    params = _params(batchnorm=True, seed=1)
    images, _ = _batch(seed=2)
    jlogits, jstats = JU.UNet3D(_spec(True)).apply(params, jnp.asarray(images), train=True)
    model = _port(params, batchnorm=True)
    with torch.no_grad():
        tlogits, tstats = model(torch.tensor(images), train=True)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    assert set(tstats) == set(jstats)
    for name in jstats:
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(tstats[name][leaf].numpy(), np.asarray(jstats[name][leaf]),
                                       atol=1e-5, rtol=1e-5, err_msg=f"{name}/{leaf}")
    # inference mode and a BN-free spec return the logits alone
    with torch.no_grad():
        assert torch.is_tensor(model(torch.tensor(images)))
        assert torch.is_tensor(_port(_params()).forward(torch.tensor(images), train=True))


def test_init_statistics():
    """JAX's init: Xavier-normal kernels (fans k^3 Cin, k^3 Cout; the upconv
    8 Cin, 8 Cout), zero biases, BN 1/0/0/1; the production UNet's widths."""
    spec = TU.NETWORK_SPECS["UNet"].replace(bias=True, batchnorm=True)
    model = TU.UNet3D(spec, device="cpu").init(torch.Generator().manual_seed(3))
    tree = export_params(model)
    jshapes = jax.eval_shape(JU.UNet3D(_spec(True).replace(**{f: getattr(spec, f) for f in ("enc", "dec")})).init,
                             jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in flatten_tree(tree).items()} == \
        {k: tuple(v.shape) for k, v in flatten_tree(jax.tree.map(lambda s: np.zeros(s.shape), jshapes)).items()}
    for name, leaves in tree.items():
        k = leaves["kernel"]
        taps = k.shape[0] * k.shape[1] * k.shape[2]
        want = np.sqrt(2.0 / (taps * (k.shape[3] + k.shape[4])))
        if k.size > 4000:
            assert abs(k.std() / want - 1) < 0.05 and abs(k.mean()) < 0.05 * want, name
        assert not leaves["bias"].any()
        if "bn" in leaves:
            bn = leaves["bn"]
            assert (bn["scale"] == 1).all() and not bn["bias"].any() and not bn["mean"].any()
            assert (bn["var"] == 1).all()
    # the same generator seed draws the same weights; parameters stay frozen
    again = TU.UNet3D(spec, device="cpu").init(torch.Generator().manual_seed(3))
    assert torch.equal(again.enc1b.kernel, model.enc1b.kernel)
    assert not any(p.requires_grad for p in model.parameters())


def _sampler_inputs():
    rng = np.random.default_rng(6)
    vols = [rng.uniform(0, 1, (12, 14, 16)).astype(np.float32), rng.uniform(0, 1, (10, 16, 12)).astype(np.float32)]
    labs = [(rng.uniform(0, 1, v.shape + (2,)) > 0.9).astype(np.float32) for v in vols]
    labs[1][:] = 0  # a volume without foreground
    return vols, labs


def test_sampler_bit_equal_to_jax():
    vols, labs = _sampler_inputs()
    kw = dict(patch_size_zyx=(4, 8, 8), batch_size=3, flip_axes=(0, 2), seed=11)
    js, ts = JS.BalancedPatchSampler(vols, labs, **kw), TS.BalancedPatchSampler(vols, labs, **kw)
    for _ in range(6):
        (ji, jl), (ti, tl) = next(js), next(ts)
        assert ti.dtype == ji.dtype and tl.dtype == jl.dtype
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_train_segmentation_matches_jax():
    """`train_segmentation` from the same params on the same sampler: the
    losses of 3 steps, the returned tree and callback calls."""
    vols, labs = _sampler_inputs()
    kw = dict(patch_size_zyx=(4, 8, 8), batch_size=2, seed=5)
    params = _params()
    jmodel = JU.UNet3D(_spec())
    _, _, jlosses = JT.train_segmentation(jmodel, JS.BalancedPatchSampler(vols, labs, **kw), 3,
                                          params=jax.tree.map(jnp.asarray, params))
    model = TU.UNet3D(_tspec(), device="cpu")
    calls = []
    tparams, opt, tlosses = TT.train_segmentation(model, TS.BalancedPatchSampler(vols, labs, **kw), 3,
                                                  params=params, log_every=2,
                                                  callback=lambda i, loss: calls.append(i))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert calls == [0, 2] and opt.count == 3
    assert set(flatten_tree(tparams)) == set(flatten_tree(params))
    # params=None draws the model's init from the generator
    _, _, losses = TT.train_segmentation(TU.UNet3D(_tspec(), device="cpu"),
                                         TS.BalancedPatchSampler(vols, labs, **kw), 2,
                                         generator=torch.Generator().manual_seed(0))
    assert len(losses) == 2 and np.isfinite(losses).all()
