"""The port's GradICON training against the JAX package on the CPU.

Width 2, grid 8x16x16, scales (2, 1), f32, the same carried parameters:
`GradICON.loss` and its gradients, 4 steps of `make_gradicon_train_step`,
`make_augmented_train_step` (the sup gating, the heads-only first step from
zero heads), the phantom pool and low-res fields (bit-equal), `utils/optim`
against optax on identical gradient sequences, the checkpoint in both
directions, and serving after training. Tolerances: losses and their terms
1e-5 relative, maps 1e-5, gradients 1e-4 of each leaf's largest (f32 sums
in another order), Adam-updated parameters 1e-6 absolute (lr 1e-3) after
the first step on elements whose gradient is above 1e-3 of the leaf's
largest (Adam moves a near-zero gradient by about +-lr whatever its size,
so rounding picks its sign), and after 4 steps 1e-5 on the leaves whose
largest gradient is above 5e-2 (the sign-noise moves of the small leaves
change later gradients through the max-pool and ReLU kinks, in both
packages alike), the optimizer 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oai_analysis_2_tpu.models import gradicon as JG
from oai_analysis_2_tpu.models import synthetic as JSyn
from oai_analysis_2_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint
from oai_analysis_2_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint
from oai_analysis_2_tpu_torch.core.image import image_from_array as timage
from oai_analysis_2_tpu_torch.engine.registration import register_pair
from oai_analysis_2_tpu_torch.models import gradicon as TG
from oai_analysis_2_tpu_torch.models import synthetic as TSyn
from oai_analysis_2_tpu_torch.utils import optim
from oai_analysis_2_tpu_torch.utils.checkpoint import flatten_tree, save_checkpoint

torch.set_num_threads(2)

GRID = (8, 16, 16)
LOWRES = (2, 4, 4)
LR = 1e-3


def _config():
    return dict(grid_shape=GRID, scales=(2, 1), stage_width=2)


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's jitted functions, compiled once for the module: the loss and
    gradient of one pair, the train step and the augmented train step."""
    model = JG.GradICON(JG.GradICONConfig(**_config()))
    opt = optax.adam(LR)
    return dict(
        model=model, opt=opt,
        loss_grad=jax.jit(jax.value_and_grad(lambda p, a, b: model.loss(p, a, b), has_aux=True)),
        train=JG.make_gradicon_train_step(model, opt),
        augmented=JSyn.make_augmented_train_step(model, opt, sup_weight=1.0, sim_weight=0.1),
    )


def _params(zero_heads=False, seed=0):
    model = JG.GradICON(JG.GradICONConfig(**_config()))
    return jax.tree.map(lambda v: np.array(v, np.float32), model.init(jax.random.PRNGKey(seed), zero_heads=zero_heads))


def _port(params):
    model = TG.GradICON(TG.GradICONConfig(**_config()), device="cpu")
    model.load_params(params)
    return model


def _volumes(n=2, seed=0):
    return TSyn.make_phantom_pool(n, GRID, seed=seed)


def _flat_list(params_list):
    return flatten_tree({f"stage{i}": p for i, p in enumerate(params_list)})


def _close_rel(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, atol=tol, rtol=0, err_msg=k)


def _close_where_grad(got: dict, want: dict, grads: dict):
    for k, g in grads.items():
        mask = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(got[k][mask], want[k][mask], atol=1e-6, rtol=0, err_msg=k)


def _port_grads(model):
    """{"stage0/enc0a/kernel": gradient} from `stages.0.enc0a.kernel`."""
    return {k.replace("stages.", "stage", 1).replace(".", "/"): p.grad.numpy().copy()
            for k, p in model.named_parameters()}


def test_loss_and_gradients_match_jax(jax_steps):
    params = _params()
    a, b = _volumes()
    (jl, (jsim, jreg, jab, jba)), jg = jax_steps["loss_grad"](params, jnp.asarray(a), jnp.asarray(b))
    model = _port(params)
    for p in model.parameters():
        p.requires_grad_(True)
    tl, (tsim, treg, tab, tba) = model.loss(torch.tensor(a), torch.tensor(b))
    tl.backward()
    for got, want in ((tl, jl), (tsim, jsim), (treg, jreg)):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(tab.detach().numpy(), np.asarray(jab), atol=1e-5)
    np.testing.assert_allclose(tba.detach().numpy(), np.asarray(jba), atol=1e-5)
    _close_rel(_port_grads(model), {k: np.asarray(v) for k, v in _flat_list(jg).items()}, 1e-4)


def test_gradicon_train_step_matches_jax(jax_steps):
    """4 Adam steps of `make_gradicon_train_step` on a batch of 2 pairs: the
    loss of every step, the parameters after the first and the fourth."""
    params = _params(seed=1)
    pool = _volumes(4, seed=3)
    jp, jstate = params, jax_steps["opt"].init(params)
    model = _port(params)
    tstep = TG.make_gradicon_train_step(model, optim.adam(list(model.parameters()), LR))
    for i in range(4):
        jp, jstate, jl = jax_steps["train"](jp, jstate, jnp.asarray(pool[:2]), jnp.asarray(pool[[3, 2]]))
        tl = tstep(torch.tensor(pool[:2]), torch.tensor(pool[[3, 2]]))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        got, want = _flat_list(model.params_list()), _flat_list(jax.tree.map(np.asarray, jp))
        if i == 0:  # the port's first gradients, within 1e-4 of JAX's (test above)
            grads0 = _port_grads(model)
            _close_where_grad(got, want, grads0)
    for k, g in grads0.items():
        if np.abs(g).max() > 5e-2:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)
    assert sum(np.abs(g).max() > 5e-2 for g in grads0.values()) >= 5


def _aug_batch(seed):
    rng = np.random.default_rng(seed)
    pool = _volumes(3, seed=4)
    ua = np.stack([TSyn.random_lowres_field(rng, LOWRES, 0.05, 0.04) for _ in range(2)])
    ub = np.stack([TSyn.random_lowres_field(rng, LOWRES, 0.05, 0.04) for _ in range(2)])
    same = np.asarray([1.0, 0.0], np.float32)  # a same-phantom pair, then a cross pair
    return pool[[0, 1]], pool[[0, 2]], ua, ub, same


@pytest.mark.parametrize("zero_heads", [True, False])
def test_augmented_train_step_matches_jax(jax_steps, zero_heads):
    """(loss, sim, reg, sup) of 2 steps (sup 1.0, sim 0.1, one same pair and
    one cross pair: sup is gated to the same pair); from zero heads the
    first step moves the heads alone, as in JAX."""
    params = _params(zero_heads=zero_heads, seed=2)
    jstep = jax_steps["augmented"]
    jp, jstate = params, jax_steps["opt"].init(params)
    model = _port(params)
    tstep = TSyn.make_augmented_train_step(model, optim.adam(list(model.parameters()), LR),
                                           sup_weight=1.0, sim_weight=0.1)
    for i in range(2):
        batch = _aug_batch(seed=20 + i)
        jp, jstate, jout = jstep(jp, jstate, *map(jnp.asarray, batch))
        tout = tstep(*map(torch.tensor, batch))
        for name, got, want in zip(("loss", "sim", "reg", "sup"), tout, jout):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7, err_msg=name)
        if i == 0 and zero_heads:
            before, after = _flat_list(params), _flat_list(model.params_list())
            moved = {k for k in before if not np.array_equal(before[k], after[k])}
            jafter = _flat_list(jax.tree.map(np.asarray, jp))
            jmoved = {k for k, v in jafter.items() if not np.array_equal(before[k], v)}
            assert moved == jmoved and moved and all(k.split("/")[1] == "head" for k in moved), moved
    # with one cross pair alone the supervision term is gated off
    va, vb, ua, ub, _ = _aug_batch(seed=30)
    out = tstep(*map(torch.tensor, (va, vb, ua, ub, np.zeros(2, np.float32))))
    assert float(out[3]) == 0.0


def test_init_zero_heads():
    """`GradICON.init` draws every stage's UNet init; with zero_heads the
    displacement heads are zero (the untrained network is the identity
    map) and the rest is drawn; the model counts as loaded."""
    cfg = TG.GradICONConfig(**_config())
    model = TG.GradICON(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    assert model.loaded
    for stage in model.params_list():
        assert not stage["head"]["kernel"].any() and not stage["head"]["bias"].any()
        assert stage["enc0a"]["kernel"].any() and not stage["enc0a"]["bias"].any()
    a, b = (torch.tensor(v) for v in _volumes())
    with torch.no_grad():
        phi = model.forward_map(a, b)
    torch.testing.assert_close(phi, TG.identity_map(GRID), atol=1e-6, rtol=0)
    drawn = TG.GradICON(cfg, device="cpu").init(torch.Generator().manual_seed(2), zero_heads=False)
    assert all(stage["head"]["kernel"].any() for stage in drawn.params_list())


def test_lowres_field_and_pool_bit_equal():
    pool_j, pool_t = JSyn.make_phantom_pool(2, GRID, seed=7), TSyn.make_phantom_pool(2, GRID, seed=7)
    assert pool_t.dtype == pool_j.dtype == np.float32
    np.testing.assert_array_equal(pool_t, pool_j)
    rj, rt = np.random.default_rng(42), np.random.default_rng(42)
    for amp, trans in ((0.035, 0.03), (0.05, 0.04)):
        fj = JSyn.random_lowres_field(rj, (3, 4, 5), amp, trans)
        ft = TSyn.random_lowres_field(rt, (3, 4, 5), amp, trans)
        assert ft.shape == (3, 4, 5, 3) and ft.dtype == fj.dtype
        np.testing.assert_array_equal(ft, fj)
    # the warp by such a field, against JAX's
    vol, u = pool_t[0], TSyn.random_lowres_field(np.random.default_rng(1), LOWRES, 0.05, 0.04)
    want = np.asarray(JSyn.apply_lowres_warp(jnp.asarray(vol), jnp.asarray(u)))
    np.testing.assert_allclose(TSyn.apply_lowres_warp(torch.tensor(vol), torch.tensor(u)).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("clip", [None, 0.05, 100.0])
def test_optimizer_matches_optax(clip):
    """Adam with optax's defaults, the global-norm clip (binding at 0.05,
    idle at 100) and the warmup-cosine schedule from lr 0 on identical
    gradient sequences."""
    rng = np.random.default_rng(8)
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in ((3, 4), (5,))]
    grads = [[rng.normal(0, 0.1, p.shape).astype(np.float32) for p in p0] for _ in range(6)]
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-2, warmup_steps=2, decay_steps=5, end_value=1e-3)
    tsched = optim.warmup_cosine_decay_schedule(0.0, 3e-2, warmup_steps=2, decay_steps=5, end_value=1e-3)
    chain = [optax.adam(sched)] if clip is None else [optax.clip_by_global_norm(clip), optax.adam(sched)]
    opt = optax.chain(*chain)
    jp, state = [jnp.asarray(p) for p in p0], None
    state = opt.init(jp)
    tp = [torch.tensor(p) for p in p0]
    topt = optim.adam(tp, tsched, clip_norm=clip)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        topt.step()
    for p, q in zip(tp, jp):
        np.testing.assert_allclose(p.numpy(), np.asarray(q), atol=1e-6, rtol=0)
    assert topt.count == 6
    for count in (0, 1, 2, 3, 5, 7):
        np.testing.assert_allclose(tsched(count), float(sched(count)), rtol=1e-6, atol=1e-12)
    assert tsched(0) == 0.0


def test_clip_formula_is_optax():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    params = [torch.zeros(2), torch.zeros(1)]
    for p, x in zip(params, g):
        p.grad = x.clone()
    norm = optim.clip_by_global_norm_(params, 1.0)
    assert float(norm) == 13.0
    torch.testing.assert_close(params[0].grad, torch.tensor([3.0, 4.0]) / 13.0, atol=0, rtol=0)
    params[0].grad = torch.tensor([0.3, 0.4])
    params[1].grad = torch.tensor([0.0])
    optim.clip_by_global_norm_(params, 1.0)
    torch.testing.assert_close(params[0].grad, torch.tensor([0.3, 0.4]), atol=0, rtol=0)


def test_checkpoint_both_ways(tmp_path):
    """A checkpoint the port writes from its trained model loads in JAX's
    `load_gradicon_checkpoint`, and JAX's loads in the port, leaf for leaf."""
    model = TG.GradICON(TG.GradICONConfig(**_config()), device="cpu").init(torch.Generator().manual_seed(1),
                                                                            zero_heads=False)
    meta = {"stage_width": 2, "grid_shape": list(GRID), "scales": [2, 1]}
    save_checkpoint({"params": {f"stage{k}": p for k, p in enumerate(model.params_list())}, "epoch": 3, **meta},
                    False, tmp_path, name="port.npz")
    jparams, jmeta = JG.load_gradicon_checkpoint(tmp_path / "port.npz")
    assert jmeta == {"stage_width": 2, "grid_shape": GRID, "scales": (2, 1)}
    assert int(jload_checkpoint(tmp_path / "port.npz")["epoch"]) == 3
    for k, v in _flat_list(jparams).items():
        np.testing.assert_array_equal(np.asarray(v), _flat_list(model.params_list())[k])
    params = _params(seed=5)
    jsave_checkpoint({"params": {f"stage{k}": p for k, p in enumerate(params)}, **meta}, False, tmp_path,
                     name="jax.npz")
    tparams, tmeta = TG.load_gradicon_checkpoint(tmp_path / "jax.npz")
    assert tmeta == jmeta
    port = _port(tparams)
    for k, v in _flat_list(params).items():
        np.testing.assert_array_equal(_flat_list(port.params_list())[k], v)


def test_serving_after_training_builds_no_graph(tmp_path):
    """After a train step (parameters now require grad), `register_pair` and
    the segmenter's `segment` return tensors without a graph."""
    import json

    from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise
    from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS, UNet3D
    from oai_analysis_2_tpu_torch.utils.checkpoint import export_params

    model = _port(_params(seed=6))
    step = TG.make_gradicon_train_step(model, optim.adam(list(model.parameters()), LR))
    step(*(torch.tensor(v)[None] for v in _volumes()))
    assert all(p.requires_grad for p in model.parameters())
    a, b = _volumes(seed=9)
    phi_ab, phi_ba = register_pair(timage(a, device="cpu"), timage(b, device="cpu"), model=model)
    assert phi_ab.field.grad_fn is None and phi_ba.field.grad_fn is None
    assert not phi_ab.field.requires_grad

    spec = NETWORK_SPECS["UNet_light4"].replace(bias=True)
    (tmp_path / "cfg.json").write_text(json.dumps({
        "patch_size": [8, 8, 4], "model": "UNet_light4",
        "model_setting": {"in_channels": 1, "n_classes": 2, "bias": True, "BN": False}}))
    save_checkpoint({"params": export_params(UNet3D(spec, device="cpu").init())}, False, tmp_path, name="seg.npz")
    seg = Segmenter3DInPatchClassWise("pred", {
        "device": "cpu", "batch_size": 2, "overlap_size": (2, 2, 1), "compute_dtype": "float32",
        "ckpoint_path": str(tmp_path / "seg.npz"), "training_config_file": str(tmp_path / "cfg.json")})
    seg.pred_setup()
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, 4, 8, 8, 1)).astype(np.float32)
    labels = (rng.uniform(0, 1, (2, 4, 8, 8, 2)) > 0.5).astype(np.float32)
    _, _, losses = seg.train(seg.model, iter([(images, labels)] * 2), 2, 1e-3,
                             generator=torch.Generator().manual_seed(1))
    assert len(losses) == 2 and all(p.requires_grad for p in seg.model.parameters())
    fc, tc = seg.segment(rng.uniform(0, 1, (8, 12, 10)).astype(np.float32), if_output_itk=False)
    assert fc.grad_fn is None and tc.grad_fn is None and not fc.requires_grad


def test_synthetic_trainer_writes_a_checkpoint_jax_reads(tmp_path, monkeypatch):
    """`python -m ...examples.train_gradicon_synthetic` as a call: 2 bf16 steps
    at width 2 on a 16x32x32 grid; the checkpoint and its `.best` sidecar,
    read by JAX's loader bit-equal to the trained model's weights."""
    from oai_analysis_2_tpu_torch.examples import train_gradicon_synthetic as trainer

    for key, value in dict(GRADICON_WIDTH="2", GRADICON_GRID="16,32,32", GRADICON_POOL="3",
                           GRADICON_LOWRES="2,4,4", GRADICON_SUP_W="1.0", GRADICON_SIM_W="0.1").items():
        monkeypatch.setenv(key, value)
    out = tmp_path / "w" / "gradicon.npz"
    summary = trainer.main(["2", "2", str(out)], device="cpu")
    assert len(summary["losses"]) == 2 and np.isfinite(summary["losses"]).all()
    assert summary["checkpoint"] == str(out) and list(summary["eval"]) == [1]
    assert float((out.parent / "gradicon.npz.best").read_text()) == pytest.approx(summary["best"], abs=1e-6)
    jparams, jmeta = JG.load_gradicon_checkpoint(out)
    assert jmeta == {"stage_width": 2, "grid_shape": (16, 32, 32), "scales": (4, 2, 1)}
    trained = _flat_list(summary["model"].params_list())
    for k, v in _flat_list(jparams).items():
        np.testing.assert_array_equal(np.asarray(v), trained[k])


def test_knee_trainer_on_nifti_pairs(tmp_path, monkeypatch):
    """`...examples.train_gradicon` on two NIfTI knees (a width-2 config on a
    16x32x32 grid in place of the default): a checkpoint JAX reads."""
    from oai_analysis_2_tpu_torch.core.nifti import write_nifti
    from oai_analysis_2_tpu_torch.examples import train_gradicon as trainer

    for i, v in enumerate(_volumes(2, seed=11)):
        write_nifti(timage(v * 500.0, spacing=(0.36, 0.36, 0.7), device="cpu"), tmp_path / f"knee{i}.nii.gz")
    monkeypatch.setattr(trainer, "GradICONConfig",
                        lambda: TG.GradICONConfig(grid_shape=(16, 32, 32), stage_width=2))
    out = trainer.main([str(tmp_path), str(tmp_path / "ckpt"), "2"], device="cpu")
    jparams, _ = JG.load_gradicon_checkpoint(out)
    assert len(jparams) == 3 and int(jload_checkpoint(out)["epoch"]) == 1
