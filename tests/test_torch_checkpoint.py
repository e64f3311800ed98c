"""The PyTorch port's reading of the reference's torch checkpoints against
the JAX package's.

A torch oracle of the reference UNet (the reference's `ec*` / `dc*` module
names, a copy of tests/test_unet3d.py's, since the tests directory is not
a package) gets seeded random weights and random batch-norm statistics and
is saved with `torch.save`. Both packages load and convert it: the trees
must agree leaf for leaf (bit-equal), and a batch-norm UNet_light1 must
give the same logits as the JAX `UNet3D` (bf16 compute, within the logits
tolerance of 5e-2 of tests/test_torch_conv.py; f32 compute within 1e-4).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from oai_analysis_2_tpu.models.unet3d import NETWORK_SPECS as JSPECS
from oai_analysis_2_tpu.models.unet3d import UNet3D as JUNet
from oai_analysis_2_tpu.utils import checkpoint as JC
from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS as TSPECS
from oai_analysis_2_tpu_torch.models.unet3d import UNet3D as TUNet
from oai_analysis_2_tpu_torch.models.unet3d import get_available_networks
from oai_analysis_2_tpu_torch.utils import checkpoint as TC

torch.set_num_threads(2)


def _enc_block(cin, cout, bias, bn):
    layers = [nn.Conv3d(cin, cout, 3, padding=1, bias=bias)]
    if bn:
        layers.append(nn.BatchNorm3d(cout))
    layers.append(nn.ReLU())
    return nn.Sequential(*layers)


def _dec_block(cin, cout, k, s, p, bias, bn):
    layers = [nn.ConvTranspose3d(cin, cout, k, stride=s, padding=p, bias=bias)]
    if bn:
        layers.append(nn.BatchNorm3d(cout))
    layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class TorchUNetOracle(nn.Module):
    """Reference-architecture UNet with the reference's parameter naming."""

    def __init__(self, spec):
        super().__init__()
        self.spec = spec
        cin = spec.in_channels
        for li, (ca, cb) in enumerate(spec.enc):
            setattr(self, f"ec{2 * li}", _enc_block(cin, ca, spec.bias, spec.batchnorm))
            setattr(self, f"ec{2 * li + 1}", _enc_block(ca, cb, spec.bias, spec.batchnorm))
            cin = cb
        self.pool = nn.MaxPool3d(2)
        L = len(spec.dec)
        cur = spec.enc[-1][1]
        for li, (cu, c1, c2) in enumerate(spec.dec):
            base = 3 * (L - li)
            skip = spec.enc[len(spec.enc) - 2 - li][1]
            setattr(self, f"dc{base}", _dec_block(cur, cu, 2, 2, 0, spec.bias, spec.batchnorm))
            setattr(self, f"dc{base - 1}", _dec_block(cu + skip, c1, 3, 1, 1, spec.bias, spec.batchnorm))
            setattr(self, f"dc{base - 2}", _dec_block(c1, c2, 3, 1, 1, spec.bias, spec.batchnorm))
            cur = c2
        self.dc0 = nn.Conv3d(cur, spec.n_classes, 1, bias=spec.bias)

    def forward(self, x):
        spec = self.spec
        skips = []
        for li in range(len(spec.enc)):
            x = getattr(self, f"ec{2 * li}")(x)
            x = getattr(self, f"ec{2 * li + 1}")(x)
            if li < len(spec.enc) - 1:
                skips.append(x)
                x = self.pool(x)
        L = len(spec.dec)
        for li in range(L):
            base = 3 * (L - li)
            up = getattr(self, f"dc{base}")(x)
            x = torch.cat([up, skips[len(skips) - 1 - li]], dim=1)
            x = getattr(self, f"dc{base - 1}")(x)
            x = getattr(self, f"dc{base - 2}")(x)
        return self.dc0(x)


def _oracle(spec, seed=0):
    """The oracle with seeded weights and, with BN, seeded running
    statistics and affine terms (the defaults would make BN the identity)."""
    torch.manual_seed(seed)
    model = TorchUNetOracle(spec)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm3d):
                n = m.num_features
                m.running_mean.copy_(torch.rand(n, generator=gen) * 0.4 - 0.2)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
                m.weight.copy_(torch.rand(n, generator=gen) * 0.4 + 0.8)
                m.bias.copy_(torch.rand(n, generator=gen) * 0.2 - 0.1)
    return model.eval()


def _state_dict(model, prefix=""):
    return {prefix + k: v.detach().numpy() for k, v in model.state_dict().items()}


def _assert_trees_equal(t_tree, j_tree):
    flat_t = TC.flatten_tree(t_tree)
    flat_j = TC.flatten_tree(jax.tree_util.tree_map(np.asarray, j_tree))
    assert set(flat_t) == set(flat_j)
    for k in flat_j:
        assert flat_t[k].dtype == flat_j[k].dtype, k
        np.testing.assert_array_equal(flat_t[k], flat_j[k], err_msg=k)


@pytest.mark.parametrize("batchnorm", [False, True])
@pytest.mark.parametrize("prefix", ["", "module."])
def test_converted_tree_matches(batchnorm, prefix):
    spec = JSPECS["UNet_light1"].replace(bias=True, batchnorm=batchnorm)
    sd = _state_dict(_oracle(spec), prefix)
    _assert_trees_equal(TC.convert_torch_unet_state_dict(sd, spec), JC.convert_torch_unet_state_dict(sd, spec))


def _classwise_sd(spec, with_heads: bool):
    """A class-wise checkpoint: the oracle's trunk, and per-class heads under
    `dc0s.{c}` or (as the reference ships them) none."""
    sd = _state_dict(_oracle(spec.replace(classwise_heads=False), seed=3))
    for k in ("dc0.weight", "dc0.bias"):
        sd.pop(k)
    if with_heads:
        rng = np.random.default_rng(5)
        for c in range(spec.n_classes):
            sd[f"dc0s.{c}.weight"] = rng.normal(0, 0.1, (1, spec.head_in, 1, 1, 1)).astype(np.float32)
            sd[f"dc0s.{c}.bias"] = rng.normal(0, 0.1, (1,)).astype(np.float32)
    return sd


def test_classwise_heads_present():
    spec = JSPECS["UNet_light1"].replace(bias=True, classwise_heads=True)
    sd = _classwise_sd(spec, with_heads=True)
    _assert_trees_equal(TC.convert_torch_unet_state_dict(sd, spec), JC.convert_torch_unet_state_dict(sd, spec))


def test_classwise_heads_missing_warn():
    """The same warning text and head shapes as the JAX package; the heads'
    values come from the port's seeded generator (not JAX's), so only the
    trunk is compared by value."""
    spec = JSPECS["UNet_light1"].replace(bias=True, classwise_heads=True)
    sd = _classwise_sd(spec, with_heads=False)
    with pytest.warns(UserWarning) as t_rec:
        got = TC.convert_torch_unet_state_dict(sd, spec)
    with pytest.warns(UserWarning) as j_rec:
        want = JC.convert_torch_unet_state_dict(sd, spec)
    assert [str(w.message) for w in t_rec] == [str(w.message) for w in j_rec]
    assert "missing per-class heads [0, 1]" in str(t_rec[0].message)
    heads = [got.pop(f"head{c}") for c in range(spec.n_classes)]
    for c, head in enumerate(heads):
        jhead = want.pop(f"head{c}")
        assert {k: v.shape for k, v in head.items()} == {k: tuple(v.shape) for k, v in jhead.items()}
        np.testing.assert_array_equal(head["bias"], 0.0)
        assert 0.0 < float(np.std(head["kernel"])) < 1.0
    _assert_trees_equal(got, want)
    with pytest.warns(UserWarning):  # an explicit generator seeded 0 draws the default heads
        again = TC.convert_torch_unet_state_dict(sd, spec, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again["head0"]["kernel"], heads[0]["kernel"])


def test_load_torch_checkpoint(tmp_path):
    spec = JSPECS["UNet_light2"].replace(bias=True)
    sd = _oracle(spec).state_dict()
    path = tmp_path / "segmentation_model.pth.tar"
    torch.save({"model_state_dict": sd, "epoch": 600, "seg_best_score": 0.91}, path)
    t_sd, t_epoch, t_best = TC.load_torch_checkpoint(path)
    j_sd, j_epoch, j_best = JC.load_torch_checkpoint(path)
    assert (t_epoch, t_best) == (j_epoch, j_best) == (600, pytest.approx(0.91))
    assert set(t_sd) == set(j_sd)
    for k in j_sd:
        np.testing.assert_array_equal(t_sd[k], j_sd[k])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_batchnorm_unet_forward_matches(dtype):
    """A batch-norm UNet_light1 from the converted checkpoint: port logits
    against the JAX UNet3D's and the torch oracle's."""
    spec = JSPECS["UNet_light1"].replace(bias=True, batchnorm=True)
    oracle = _oracle(spec, seed=7)
    params = TC.convert_torch_unet_state_dict(_state_dict(oracle), spec)
    x = np.random.default_rng(8).uniform(0, 1, (2, 16, 24, 32, 1)).astype(np.float32)
    tmodel = TUNet(TSPECS["UNet_light1"].replace(bias=True, batchnorm=True),
                   compute_dtype=getattr(torch, dtype), device="cpu")
    TC.carry_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(torch.tensor(x)).numpy()
        want_oracle = oracle(torch.tensor(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).numpy()
    want = np.asarray(JUNet(spec, compute_dtype=getattr(jnp, dtype)).apply(params, jnp.asarray(x)))
    tol = 5e-2 if dtype == "bfloat16" else 1e-4
    assert got.shape == want.shape == (2, 16, 24, 32, 2)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(got, want_oracle, atol=tol, rtol=0)


def test_carry_params_takes_bn_statistics():
    """The bn subtree lands on the block's BN module: scale and bias as
    parameters, mean and var as buffers; a missing leaf raises."""
    spec = TSPECS["UNet_light4"].replace(bias=True, batchnorm=True)
    params = TC.convert_torch_unet_state_dict(_state_dict(_oracle(spec, seed=2)), spec)
    model = TUNet(spec, device="cpu")
    TC.carry_params(model, params)
    np.testing.assert_array_equal(model.enc0a.bn.var.numpy(), params["enc0a"]["bn"]["var"])
    np.testing.assert_array_equal(model.dec0up.bn.mean.numpy(), params["dec0up"]["bn"]["mean"])
    assert model.head.bn is None
    del params["enc1b"]["bn"]["var"]
    with pytest.raises(KeyError, match="enc1b.bn.var"):
        TC.carry_params(model, params)


def test_network_registry():
    from oai_analysis_2_tpu.models.unet3d import get_available_networks as jnets

    assert get_available_networks() == jnets()
    for n in jnets():
        assert dataclasses.asdict(TSPECS[n]) == dataclasses.asdict(JSPECS[n]), n


@pytest.mark.parametrize("source", ["npz", "pth.tar", "fresh"])
def test_initialize_model_matches(tmp_path, source):
    """`initialize_model` in both packages: an npz checkpoint and a torch
    `.pth.tar` give the same tree (within 1e-6), epoch and best score; a
    fresh init gives the same keys and shapes, epoch 0 and best score 0
    (the two packages draw from different generators)."""
    spec = JSPECS["UNet_light2"].replace(bias=True)
    tmodel = TUNet(TSPECS["UNet_light2"].replace(bias=True), device="cpu")
    jmodel = JUNet(spec)
    path = None
    if source == "npz":
        params = TC.export_params(tmodel.init(torch.Generator().manual_seed(3)))
        path = TC.save_checkpoint({"params": params, "epoch": 7, "best_score": 0.625}, tmp_path / "ck.npz")
    elif source == "pth.tar":
        path = tmp_path / "segmentation_model.pth.tar"
        torch.save({"model_state_dict": _oracle(spec).state_dict(), "epoch": 600, "best_score": 0.875}, path)
    t_params, t_epoch, t_best = TC.initialize_model(tmodel, torch.Generator().manual_seed(0), path)
    j_params, j_epoch, j_best = JC.initialize_model(jmodel, jax.random.PRNGKey(0), path)
    assert (t_epoch, t_best) == (j_epoch, j_best)
    assert (t_epoch, t_best) == {"npz": (7, 0.625), "pth.tar": (600, 0.875), "fresh": (0, 0.0)}[source]
    flat_t = TC.flatten_tree(t_params)
    flat_j = TC.flatten_tree(jax.tree_util.tree_map(np.asarray, j_params))
    assert set(flat_t) == set(flat_j)
    for k, v in flat_j.items():
        assert flat_t[k].shape == v.shape, k
        if source != "fresh":
            np.testing.assert_allclose(flat_t[k], v, atol=1e-6, rtol=1e-6, err_msg=k)
    if source == "fresh":  # the module carries what was returned
        TC.carry_params(tmodel, t_params)


def test_initialize_model_refuses_a_missing_file(tmp_path):
    tmodel = TUNet(TSPECS["UNet_light2"].replace(bias=True), device="cpu")
    with pytest.raises(ValueError, match="no checkpoint"):
        TC.initialize_model(tmodel, ckpoint_path=tmp_path / "missing.npz")


@pytest.mark.parametrize("n_classes,absent", [(3, None), (4, 2)])
def test_weight_from_truth_matches(n_classes, absent):
    """Inverse class-frequency weights of the same labels in both packages,
    within 1e-6; an absent class weighs 0."""
    rng = np.random.default_rng(6)
    labels = rng.choice(n_classes, size=(2, 6, 7, 5), p=np.linspace(1, 3, n_classes) / np.linspace(1, 3, n_classes).sum())
    if absent is not None:
        labels[labels == absent] = 0
    want = np.asarray(JC.weight_from_truth(jnp.asarray(labels), n_classes))
    got = TC.weight_from_truth(torch.as_tensor(labels), n_classes)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n_classes,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    if absent is not None:
        assert float(got[absent]) == 0.0
    np.testing.assert_allclose(TC.weight_from_truth(labels, n_classes).numpy(), want, atol=1e-6, rtol=1e-6)
