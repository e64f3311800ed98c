"""The port's auto-context cascades (`models/cascade.py`) against the JAX
package on the CPU: `make_unet_light4x2` with carried parameters (final and
per-stage logits), an auto-context cascade without the residual, one
recurrent `auto_context_step` from `init_hidden`, and which parameters a
cascade trains. Logits within 1e-4 (f32 convs summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oai_analysis_2_tpu.models import cascade as JC
from oai_analysis_2_tpu.models import unet3d as JU
from oai_analysis_2_tpu_torch.models import cascade as TC
from oai_analysis_2_tpu_torch.models import unet3d as TU
from oai_analysis_2_tpu_torch.utils.checkpoint import carry_params

torch.set_num_threads(2)

X_SHAPE = (1, 4, 8, 8, 1)


def _numpy(tree):
    return jax.tree.map(lambda v: np.array(v, np.float32), tree)


def _x(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, X_SHAPE).astype(np.float32)


@pytest.mark.parametrize("residual", [True, False])
def test_cascade_matches_jax(residual):
    jmodel = JC.make_unet_light4x2(bias=True)
    tmodel = TC.make_unet_light4x2(bias=True, device="cpu")
    if not residual:
        specs = [s.spec for s in jmodel.stages]
        jmodel = JC.CascadedUNet(specs, residual=False)
        tmodel = TC.CascadedUNet([TU.NETWORK_SPECS["UNet_light4"].replace(bias=True, in_channels=c)
                                  for c in (1, 3)], residual=False, device="cpu")
    params = _numpy(jmodel.init(jax.random.PRNGKey(1)))
    carry_params(tmodel, {"stages": {str(i): p for i, p in enumerate(params)}})
    x = _x()
    want = jmodel.apply(params, jnp.asarray(x), multi_output=True)
    with torch.no_grad():
        got = tmodel(torch.tensor(x), multi_output=True)
        final = tmodel(torch.tensor(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(final.numpy(), got[-1].numpy())


def test_auto_context_step_matches_jax():
    spec_j = JU.NETWORK_SPECS["UNet_light4"].replace(bias=True, in_channels=3)
    params = _numpy(JU.UNet3D(spec_j).init(jax.random.PRNGKey(2)))
    model = TU.UNet3D(TU.NETWORK_SPECS["UNet_light4"].replace(bias=True, in_channels=3), device="cpu")
    carry_params(model, params)
    x = _x(seed=3)
    jh = JC.init_hidden(X_SHAPE[:-1], 2)
    th = TC.init_hidden(X_SHAPE[:-1], 2, device="cpu")
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    for residual in (0, 1):
        jp, jnew = JC.auto_context_step(JU.UNet3D(spec_j), params, jnp.asarray(x), jh, residual, 0.5)
        with torch.no_grad():
            tp, tnew = TC.auto_context_step(model, torch.tensor(x), th, residual, 0.5)
        np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)


def test_cascade_trainable_params_and_init():
    """The last stage alone unless end2end; the init draws every stage."""
    model = TC.make_unet_light4x2(device="cpu").init(torch.Generator().manual_seed(0))
    last = list(model.stages[-1].parameters())
    assert [id(p) for p in model.trainable_params()] == [id(p) for p in last]
    assert len(model.trainable_params(end2end=True)) == 2 * len(last)
    assert all(float(s.enc0a.kernel.abs().sum()) > 0 for s in model.stages)
    assert model.stages[1].spec.in_channels == 3
