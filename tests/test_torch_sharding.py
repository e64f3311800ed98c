"""The port's multi-card path (`parallel/sharding.py`, the UNet's z halo and
`BatchKneePipeline(mesh=...)`) against the JAX package's, on the CPU.

Each fixture spawns 2 or 4 ranks with `torch.multiprocessing` (gloo, a
`file://` rendezvous under the test's temporary directory, one thread a
rank, a 60 s collective timeout, and a deadline after which the ranks are
killed, so that a hung collective fails its test). The rank bodies are the
`_rank_*` functions below: this module imports only torch and the port at
its top, so that a rank that imports it imports nothing of JAX; the JAX
side runs in the test process on the conftest's 8-device CPU mesh. The
inputs come from numpy seeds, and every rank writes its results to an
`.npz` that the tests hold against JAX's sharded functions on meshes of the
same shape and against the port's unsharded functions.

Tolerances: losses 1e-5 relative; gradients 1e-4 of each leaf's largest
element (f32 sums in another order); parameters after one Adam step (lr
1e-3) 1e-6 absolute where the gradient is above 1e-3 of the leaf's largest
(elsewhere Adam moves by about +-lr whatever the gradient's size);
inference 2e-5 (JAX's own test); the z-halo forward 1e-5 of the unsharded
forward; the knee batch's device stages 1e-4 (tests/test_torch_batch.py).
Results that the collectives carry (replicated parameters, gathered maps
and meshes) are compared bit for bit.
"""

import datetime
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from oai_analysis_2_tpu_torch.core.image import image_from_array as timage
from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise as TSeg
from oai_analysis_2_tpu_torch.models import gradicon as TG
from oai_analysis_2_tpu_torch.models import unet3d as TU
from oai_analysis_2_tpu_torch.parallel import BatchKneePipeline, CohortRunner, make_device_mesh, shard_batch
from oai_analysis_2_tpu_torch.parallel import sharding as TS
from oai_analysis_2_tpu_torch.utils import optim
from oai_analysis_2_tpu_torch.utils.checkpoint import carry_params, flatten_tree, unflatten_tree

LR = 1e-3
DEADLINE_S = 150
# train-step cases: (ranks, mesh shape, spatial_shard, volume depth D, the
# JAX step held against: its sharded step on a mesh of that shape, or its
# unsharded step). JAX's sharded step on the 2 x 2 CPU mesh at D = 4 (a
# z-block of 2, one plane after the pool) disagrees with its own unsharded
# gradient (enc1a's leaves by their whole size, enc0's by 5 %), so that case
# is held against the unsharded step, which the sharded one computes by
# definition; at D = 8 on the same mesh JAX's two agree.
TRAIN_CASES = {
    "data_2x1": (2, (2, 1), False, 4, "sharded"),
    "replicas_2x2": (4, (2, 2), False, 4, "sharded"),
    "spatial_2x2": (4, (2, 2), True, 4, "unsharded"),
    "spatial_2x2_d8": (4, (2, 2), True, 8, "sharded"),
    "spatial_1x4": (4, (1, 4), True, 8, "sharded"),
}
# z-halo forwards on a 1 x 4 mesh (the middle ranks take a plane from each
# side): (spec, batch shape N, D, H, W)
HALO_CASES = {"light4_d8": ("UNet_light4", (2, 8, 8, 8)), "light2_d16": ("UNet_light2", (1, 16, 8, 8))}
GRADICON = dict(grid_shape=(16, 16, 16), scales=(2, 1), stage_width=2)
N_PAIRS = 4
BATCH_REG = dict(grid_shape=(8, 16, 16), scales=(2, 1), stage_width=2)  # tests/test_torch_batch.py's
BATCH_SPACING = (0.5, 0.5, 1.0)
THICK_SHAPE, THICK_SPACING = (12, 40, 40), (0.5, 0.5, 0.5)


# ---- the ranks ---------------------------------------------------------------------


def _rank_main(rank, world, rendezvous, body, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        body(rank, Path(out))
    finally:
        dist.destroy_process_group()


def _spawn(body, world, tmp_path):
    """Run `body(rank, tmp_path)` in `world` ranks; a rank that raises fails
    the call, and ranks still running at the deadline are killed."""
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp_path / "rendezvous"), body, str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                raise TimeoutError(f"{world} ranks still running after {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _save(path: Path, **arrays):
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


def _load_tree(path: Path) -> dict:
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def _leaves(module) -> dict:
    return {k.replace(".", "/"): p.detach().numpy().copy() for k, p in module.named_parameters()}


def _grads(module) -> dict:
    return {k.replace(".", "/"): p.grad.numpy().copy() for k, p in module.named_parameters()}


def _unet(spec_name, rank, params=None, bias=False):
    """The UNet with `params` on rank 0 and another init elsewhere, which
    the sharded functions' `replicate` must overwrite."""
    model = TU.UNet3D(TU.NETWORK_SPECS[spec_name].replace(bias=bias), device="cpu")
    if rank == 0 and params is not None:
        carry_params(model, params)
    else:
        model.init(torch.Generator().manual_seed(100 + rank))
    return model


def _train_inputs(depth):
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (4, depth, 8, 8, 1)).astype(np.float32)
    labels = (rng.uniform(0, 1, (4, depth, 8, 8, 2)) > 0.6).astype(np.float32)
    return images, labels


def _rank_train(rank, out, names):
    params = _load_tree(out / "unet_params.npz")
    for name in names:
        _, shape, spatial, depth, _ = TRAIN_CASES[name]
        mesh = make_device_mesh(*shape, device_type="cpu")
        model = _unet("UNet_light4", rank, params, bias=True)
        run = TS.make_sharded_train_step(model, optim.adam(list(model.parameters()), LR), mesh,
                                         spatial_shard=spatial)
        loss = run(*_train_inputs(depth))
        _save(out / f"train_{name}_rank{rank}.npz", loss=float(loss),
              **{f"grad/{k}": v for k, v in _grads(model).items()},
              **{f"param/{k}": v for k, v in _leaves(model).items()})


def _rank_mesh_checks(rank, out):
    """make_device_mesh refuses a world-size mismatch (and a card it does
    not have); shard_batch refuses an indivisible batch and returns the
    rank's blocks; replicate gives rank 0's tree to every rank."""
    report = {}
    try:
        make_device_mesh(n_data=3, device_type="cpu")
    except ValueError as err:
        report["mismatch"] = str(err)
    try:
        make_device_mesh(n_data=1, n_space=1, device_type="cpu")
    except ValueError as err:
        report["too_small"] = str(err)
    if not torch.cuda.is_available():
        try:
            make_device_mesh()
        except RuntimeError as err:
            report["no_card"] = str(err)
    mesh = make_device_mesh(device_type="cpu")
    report["shape"] = list(mesh.shape)
    report["dims"] = list(mesh.mesh_dim_names)
    try:
        shard_batch(mesh, np.zeros((3, 4)))
    except ValueError as err:
        report["indivisible"] = str(err)
    batch = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
    report["block"] = shard_batch(mesh, batch).tolist()
    tree = TS.replicate(mesh, {"a": np.full(3, rank, np.float32), "b": [np.arange(2) + rank]})
    report["replicated"] = [tree["a"].tolist(), tree["b"][0].tolist()]
    model = TS.replicate(mesh, _unet("UNet_light4", rank))
    _save(out / f"mesh_replicated_rank{rank}.npz", **_leaves(model))
    try:
        step = TS.make_sharded_train_step(model, optim.adam(list(model.parameters()), LR), mesh)
        step(*(a[:3] for a in _train_inputs(4)))
    except ValueError as err:
        report["step_indivisible"] = str(err)
    (out / f"mesh_rank{rank}.json").write_text(json.dumps(report))


def _rank_gradicon(rank, out):
    mesh = make_device_mesh(device_type="cpu")
    model = TG.GradICON(TG.GradICONConfig(**GRADICON), device="cpu")
    if rank == 0:
        with np.load(out / "gradicon_params.npz") as z:
            tree = unflatten_tree({k: z[k] for k in z.files})
        model.load_params([tree[f"stage{i}"] for i in range(len(GRADICON["scales"]))])
    else:
        model.init(torch.Generator().manual_seed(7), zero_heads=False)
    run = TS.make_sharded_gradicon_train_step(model, optim.adam(list(model.parameters()), LR), mesh)
    with np.load(out / "gradicon_pairs.npz") as z:
        loss = run(z["a"], z["b"])
    grads = {k.replace("stages.", "stage", 1).replace(".", "/"): p.grad.numpy().copy()
             for k, p in model.named_parameters()}
    _save(out / f"gradicon_rank{rank}.npz", loss=float(loss), **{f"grad/{k}": v for k, v in grads.items()},
          **{f"param/{k}": v for k, v in flatten_tree({f"stage{i}": p for i, p in
                                                       enumerate(model.params_list())}).items()})


def _rank_inference(rank, out):
    mesh = make_device_mesh(n_data=2, n_space=2, device_type="cpu")
    model = _unet("UNet_light4", rank, _load_tree(out / "infer_params.npz"))
    with np.load(out / "infer_tiles.npz") as z:
        probs = TS.make_sharded_inference(model, mesh)(z["tiles"])
    _save(out / f"infer_rank{rank}.npz", probs=probs.numpy())


def _rank_halo(rank, out):
    mesh = make_device_mesh(n_data=1, n_space=4, device_type="cpu")
    halo = TS.ZHalo(mesh)
    rng = np.random.default_rng(11)
    results = {}
    for name, (spec, shape) in HALO_CASES.items():
        model = TS.replicate(mesh, _unet(spec, rank, bias=True))
        x = rng.uniform(0, 1, shape + (1,)).astype(np.float32)
        with torch.no_grad():
            block = model(shard_batch(mesh, x, spatial_axis=1), halo=halo)
            results[f"{name}/sharded"] = torch.cat(list(TS.gather_slots(block, mesh.get_group("space"))), 1)
            results[f"{name}/whole"] = model(torch.as_tensor(x))
    try:  # UNet_light2 pools twice: a z-block of 2 does not divide by 4
        model(shard_batch(mesh, np.zeros((1, 8, 8, 8, 1), np.float32), spatial_axis=1), halo=halo)
    except ValueError as err:
        results["raised"] = str(err)
    _save(out / f"halo_rank{rank}.npz", **results)


def _rank_batch(rank, out):
    """The knee batch over 2 ranks: (a) the device stages of 3 knees in
    chunks of 2 (the second chunk padded), network mode with no and with 2
    fine-tuning steps, the latter also unsharded on rank 0; (b) run_batch
    with thickness on 2 knees, each rank's own knee also through an
    unsharded run_batch in the same process."""
    mesh = make_device_mesh(device_type="cpu")
    cfg = json.loads((out / "seg_config.json").read_text())
    seg = lambda: TSeg("pred", dict(cfg, device="cpu"))  # noqa: E731
    with np.load(out / "batch_inputs.npz") as z:
        knees, atlas, thick_knees, thick_atlas = z["knees"], z["atlas"], z["thick_knees"], z["thick_atlas"]
    net = _load_tree(out / "batch_net_params.npz")
    results = {}
    for steps, meshes in ((0, [mesh]), (2, [mesh, None] if rank == 0 else [mesh])):
        for on in meshes:
            pipe = BatchKneePipeline(seg(), timage(atlas, spacing=BATCH_SPACING, device="cpu"), mesh=on,
                                     registration_config=TG.GradICONConfig(**BATCH_REG), registration_mode="network",
                                     finetune_steps=steps, max_batch_per_device=1, device="cpu")
            pipe.registerer.load_params([net[f"stage{i}"] for i in range(len(BATCH_REG["scales"]))])
            tag = f"finetune{steps}" + ("" if on is not None else "/unsharded")
            results[f"{tag}/warped"], results[f"{tag}/disp"] = pipe.run_device_batch(
                [timage(k, spacing=BATCH_SPACING, device="cpu") for k in knees])
            results[f"{tag}/n_devices"] = pipe.n_devices

    kw = dict(registration_config=TG.GradICONConfig(**BATCH_REG), registration_mode="instance",
              instance_scales=(2,), instance_steps=(0,))
    imgs = [timage(k, spacing=THICK_SPACING, device="cpu") for k in thick_knees]
    atlas_img = timage(thick_atlas, spacing=THICK_SPACING, device="cpu")
    sharded = BatchKneePipeline(seg(), atlas_img, mesh=mesh, **kw).run_batch(imgs)
    alone = BatchKneePipeline(seg(), atlas_img, device="cpu", **kw).run_batch(imgs[rank : rank + 1])[0]
    results["n_results"] = len(sharded)
    for i, r in enumerate(sharded):
        for name in ("fc_inner", "fc_outer", "tc_inner", "tc_outer"):
            results[f"knee{i}/{name}/vertices"] = getattr(r, name).vertices
            results[f"knee{i}/{name}/thickness"] = getattr(r, name).point_data
        results[f"knee{i}/fc_probmap"] = r.fc_probmap.data.numpy()
    for name in ("fc_inner", "fc_outer", "tc_inner", "tc_outer"):
        results[f"alone/{name}/vertices"] = getattr(alone, name).vertices
        results[f"alone/{name}/thickness"] = getattr(alone, name).point_data
    results["alone/fc_probmap"] = alone.fc_probmap.data.numpy()
    _save(out / f"batch_rank{rank}.npz", **results)


def _rank_cohort(rank, out):
    """CohortRunner with the group up and no `host`: the ranks share one
    manifest and claim the items between them."""
    done = []

    def pipeline(item):
        time.sleep(1.0)  # long enough that a rank starting a little late still finds items
        done.append(item)
        return {"rank": rank}

    dist.barrier()
    runner = CohortRunner(pipeline, out / "cohort" / "manifest.json", verbose=False, poll_seconds=0.1)
    summary = runner.run(list(range(4)), keys=[f"knee{i}" for i in range(4)])
    (out / f"cohort_rank{rank}.json").write_text(json.dumps({"summary": summary, "done": done,
                                                             "host": runner.host, "n_hosts": runner.n_hosts}))


def _rank_two(rank, out):
    _rank_mesh_checks(rank, out)
    _rank_train(rank, out, [n for n, c in TRAIN_CASES.items() if c[0] == 2])
    _rank_gradicon(rank, out)
    _rank_batch(rank, out)
    _rank_cohort(rank, out)


def _rank_four(rank, out):
    _rank_train(rank, out, [n for n, c in TRAIN_CASES.items() if c[0] == 4])
    _rank_inference(rank, out)
    _rank_halo(rank, out)


# ---- the test process: inputs, the JAX references, the comparisons ----------------


def _unet_params(seed=0):
    """JAX's UNet_light4 init (with biases) as numpy, the biases drawn so
    that every leaf carries a gradient."""
    import jax

    from oai_analysis_2_tpu.models import unet3d as JU

    tree = jax.tree.map(np.asarray, JU.UNet3D(JU.NETWORK_SPECS["UNet_light4"].replace(bias=True)).init(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    flat = {k: (rng.normal(0, 0.1, v.shape) if k.endswith("bias") else v).astype(np.float32)
            for k, v in flatten_tree(tree).items()}
    return flat


def _gradicon_inputs():
    import jax

    from oai_analysis_2_tpu.models import gradicon as JG

    params = JG.GradICON(JG.GradICONConfig(**GRADICON)).init(jax.random.PRNGKey(0), zero_heads=False)
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (N_PAIRS,) + GRADICON["grid_shape"]).astype(np.float32)
    b = rng.uniform(0, 1, (N_PAIRS,) + GRADICON["grid_shape"]).astype(np.float32)
    return [jax.tree.map(np.asarray, p) for p in params], a, b


def _batch_inputs(tmp_path):
    """tests/test_torch_batch.py's fixture: its threshold UNet_light4, its
    three 8x32x32 knees and atlas, its random-init GradICON (grid 8x16x16,
    width 2); and the 12x40x40 knees of its thickness fixture."""
    import jax

    from oai_analysis_2_tpu.models.gradicon import GradICON as JGradICON
    from oai_analysis_2_tpu.models.gradicon import GradICONConfig as JConfig
    from oai_analysis_2_tpu_torch.utils.checkpoint import save_checkpoint
    from test_torch_batch import SHAPE, _knee

    (tmp_path / "cfg.json").write_text(json.dumps({
        "patch_size": [32, 32, 8], "model": "UNet_light4",
        "model_setting": {"in_channels": 1, "n_classes": 2, "bias": True, "BN": False},
    }))
    save_checkpoint({"params": TU.make_threshold_params(TU.NETWORK_SPECS["UNet_light4"].replace(bias=True)),
                     "epoch": 1}, False, tmp_path, name="seg.npz")
    seg_config = {"ckpoint_path": str(tmp_path / "seg.npz"), "training_config_file": str(tmp_path / "cfg.json"),
                  "batch_size": 4, "overlap_size": [8, 8, 2], "compute_dtype": "float32"}
    rng = np.random.default_rng(3)
    knees = np.stack([_knee(rng, i) for i in range(3)])
    atlas = rng.uniform(0, 1, SHAPE).astype(np.float32)
    rng = np.random.default_rng(5)
    thick_knees = np.stack([_knee(rng, s, THICK_SHAPE, radius=12.0) for s in (0, 2)])
    thick_atlas = _knee(rng, 1, THICK_SHAPE, radius=12.0)
    net = JGradICON(JConfig(**BATCH_REG)).init(jax.random.PRNGKey(0), zero_heads=False)
    return seg_config, knees, atlas, thick_knees, thick_atlas, net


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("two_ranks")
    _save(out / "unet_params.npz", **_unet_params())
    params, a, b = _gradicon_inputs()
    _save(out / "gradicon_params.npz", **flatten_tree({f"stage{i}": p for i, p in enumerate(params)}))
    _save(out / "gradicon_pairs.npz", a=a, b=b)
    seg_config, knees, atlas, thick_knees, thick_atlas, net = _batch_inputs(out)
    (out / "seg_config.json").write_text(json.dumps(seg_config))
    _save(out / "batch_inputs.npz", knees=knees, atlas=atlas, thick_knees=thick_knees, thick_atlas=thick_atlas)
    _save(out / "batch_net_params.npz", **flatten_tree({f"stage{i}": p for i, p in enumerate(net)}))
    _spawn(_rank_two, 2, out)
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    import jax

    from oai_analysis_2_tpu.models import unet3d as JU

    out = tmp_path_factory.mktemp("four_ranks")
    _save(out / "unet_params.npz", **_unet_params())
    infer = JU.UNet3D(JU.NETWORK_SPECS["UNet_light4"]).init(jax.random.PRNGKey(1))
    _save(out / "infer_params.npz", **flatten_tree(jax.tree.map(np.asarray, infer)))
    _save(out / "infer_tiles.npz", tiles=np.random.default_rng(2).standard_normal((5, 4, 8, 8, 1)).astype(np.float32))
    _spawn(_rank_four, 4, out)
    return out


def _ranks_npz(out: Path, stem: str) -> list:
    files = sorted(out.glob(f"{stem}_rank*.npz"))
    loaded = []
    for f in files:
        with np.load(f) as z:
            loaded.append({k: z[k] for k in z.files})
    return loaded


def _capture_then_adam():
    """optax: the gradients kept as the first state, then Adam (lr 1e-3)."""
    import jax
    import jax.numpy as jnp
    import optax

    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, state, params=None: (g, g))
    return optax.chain(keep, optax.adam(LR))


def _prefixed(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _close_rel(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, atol=tol, rtol=0, err_msg=k)


def _close_where_grad(got: dict, want: dict, grads: dict):
    for k, g in grads.items():
        mask = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(got[k][mask], want[k][mask], atol=1e-6, rtol=0, err_msg=k)


def _same_on_every_rank(ranks: list, keys=None):
    for r in ranks[1:]:
        for k in keys or ranks[0]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def test_device_mesh_and_placement(two_ranks):
    """A 2-rank group: make_device_mesh raises on a world-size mismatch (and
    for a card this machine lacks), builds the (2, 1) ("data", "space")
    mesh; shard_batch raises on an indivisible batch and gives each rank
    its rows; replicate copies rank 0's tree and module; the sharded step
    refuses a batch of 3 on 2 data ranks."""
    reports = [json.loads((two_ranks / f"mesh_rank{r}.json").read_text()) for r in range(2)]
    rows = np.arange(24, dtype=np.float32).reshape(4, 6)
    for rank, rep in enumerate(reports):
        assert "3 x 1 mesh needs 3 ranks" in rep["mismatch"] and "1 x 1 mesh" in rep["too_small"]
        if not torch.cuda.is_available():
            assert "CUDA" in rep["no_card"]
        assert rep["shape"] == [2, 1] and rep["dims"] == ["data", "space"]
        assert "does not split into 2" in rep["indivisible"] and "does not split" in rep["step_indivisible"]
        assert rep["block"] == rows[2 * rank : 2 * rank + 2].tolist()
        assert rep["replicated"] == [[0.0, 0.0, 0.0], [0, 1]]
    _same_on_every_rank(_ranks_npz(two_ranks, "mesh_replicated"))


def _jax_train(name, images, labels, params):
    import jax
    import jax.numpy as jnp

    from oai_analysis_2_tpu.engine.training import make_train_step
    from oai_analysis_2_tpu.models import unet3d as JU
    from oai_analysis_2_tpu.parallel.sharding import make_device_mesh as jmesh
    from oai_analysis_2_tpu.parallel.sharding import make_sharded_train_step as jstep

    _, shape, spatial, _, reference = TRAIN_CASES[name]
    model = JU.UNet3D(JU.NETWORK_SPECS["UNet_light4"].replace(bias=True))
    opt = _capture_then_adam()
    tree = jax.tree.map(jnp.asarray, unflatten_tree(params))
    if reference == "sharded":
        run = jstep(model, opt, jmesh(*shape), spatial_shard=spatial)
    else:
        run = make_train_step(model, opt)
    new, state, loss = run(tree, opt.init(tree), jnp.asarray(images), jnp.asarray(labels))
    flat = lambda t: flatten_tree(jax.tree.map(np.asarray, t))  # noqa: E731
    return float(loss), flat(state[0]), flat(new)


def _port_unsharded_grads(images, labels, params):
    from oai_analysis_2_tpu_torch.engine.training import dice_bce_loss

    model = TU.UNet3D(TU.NETWORK_SPECS["UNet_light4"].replace(bias=True), device="cpu")
    carry_params(model, unflatten_tree(params))
    for p in model.parameters():
        p.requires_grad_(True)
    loss = dice_bce_loss(model(torch.as_tensor(images)), torch.as_tensor(labels))
    loss.backward()
    return float(loss.detach()), _grads(model)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_sharded_train_step_matches_jax(name, two_ranks, four_ranks):
    """One step of make_sharded_train_step: the global loss and the
    all-reduced gradients against JAX's step (`TRAIN_CASES`) and against
    the port's unsharded gradient, the parameters after the Adam step
    against JAX's, and bit-equal parameters on every rank.
    The spatial cases split D over `space`, so dice_bce_loss's per-sample
    sums run across ranks, and a gradient counted n_space times shows."""
    out = two_ranks if TRAIN_CASES[name][0] == 2 else four_ranks
    params = _unet_params()
    images, labels = _train_inputs(TRAIN_CASES[name][3])
    ranks = _ranks_npz(out, f"train_{name}")
    assert len(ranks) == TRAIN_CASES[name][0]
    _same_on_every_rank(ranks)
    jloss, jgrads, jparams = _jax_train(name, images, labels, params)
    uloss, ugrads = _port_unsharded_grads(images, labels, params)
    got = ranks[0]
    np.testing.assert_allclose(float(got["loss"]), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), uloss, rtol=1e-5)
    grads = _prefixed(got, "grad/")
    _close_rel(grads, jgrads, 1e-4)
    _close_rel(grads, ugrads, 1e-4)
    _close_where_grad(_prefixed(got, "param/"), jparams, jgrads)


def test_sharded_gradicon_step_matches_jax(two_ranks):
    """make_sharded_gradicon_train_step (width 2, 16^3, 4 pairs over 2
    ranks) against JAX's on a 2-device mesh: loss, gradients, parameters
    after the step; every rank holds the same parameters."""
    import jax
    import jax.numpy as jnp

    from oai_analysis_2_tpu.models import gradicon as JG
    from oai_analysis_2_tpu.parallel.sharding import make_device_mesh as jmesh
    from oai_analysis_2_tpu.parallel.sharding import make_sharded_gradicon_train_step as jstep

    params, a, b = _gradicon_inputs()
    opt = _capture_then_adam()
    tree = jax.tree.map(jnp.asarray, params)
    run = jstep(JG.GradICON(JG.GradICONConfig(**GRADICON)), opt, jmesh(n_data=2))
    new, state, loss = run(tree, opt.init(tree), jnp.asarray(a), jnp.asarray(b))
    flat = lambda t: flatten_tree({f"stage{i}": p for i, p in enumerate(jax.tree.map(np.asarray, t))})  # noqa: E731
    ranks = _ranks_npz(two_ranks, "gradicon")
    assert len(ranks) == 2
    _same_on_every_rank(ranks)
    np.testing.assert_allclose(float(ranks[0]["loss"]), float(loss), rtol=1e-5)
    jgrads = flat(state[0])
    _close_rel(_prefixed(ranks[0], "grad/"), jgrads, 1e-4)
    _close_where_grad(_prefixed(ranks[0], "param/"), flat(new), jgrads)


def test_sharded_inference_matches_jax(four_ranks):
    """5 tiles over 4 ranks (padded to 8): every rank returns the 5 tiles'
    probabilities, within 2e-5 of JAX's sharded inference on a 2 x 2 mesh."""
    import jax
    import jax.numpy as jnp

    from oai_analysis_2_tpu.models import unet3d as JU
    from oai_analysis_2_tpu.parallel.sharding import make_device_mesh as jmesh
    from oai_analysis_2_tpu.parallel.sharding import make_sharded_inference as jinfer

    model = JU.UNet3D(JU.NETWORK_SPECS["UNet_light4"])
    with np.load(four_ranks / "infer_tiles.npz") as z:
        tiles = z["tiles"]
    want = np.asarray(jinfer(model, jmesh(n_data=2, n_space=2))(model.init(jax.random.PRNGKey(1)),
                                                                 jnp.asarray(tiles)))
    ranks = _ranks_npz(four_ranks, "infer")
    assert len(ranks) == 4
    _same_on_every_rank(ranks)
    assert ranks[0]["probs"].shape == want.shape == (5, 4, 8, 8, 2)
    np.testing.assert_allclose(ranks[0]["probs"], want, atol=2e-5)


@pytest.mark.parametrize("name", list(HALO_CASES))
def test_halo_forward_matches_unsharded(name, four_ranks):
    """The UNet with the z halo over a 1 x 4 mesh, its blocks gathered,
    within 1e-5 of the unsharded port forward (f32) on every rank; a block
    that the pooling does not divide raises."""
    ranks = _ranks_npz(four_ranks, "halo")
    assert len(ranks) == 4
    _same_on_every_rank(ranks, [f"{name}/sharded"])
    got, want = ranks[0][f"{name}/sharded"], ranks[0][f"{name}/whole"]
    assert got.shape == want.shape == HALO_CASES[name][1] + (2,)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert all("does not divide by 4" in str(r["raised"]) for r in ranks)


def test_batch_pipeline_device_stages_match_jax(two_ranks):
    """BatchKneePipeline(mesh=...) on 2 ranks, 3 knees in chunks of 2 (the
    second padded): every rank returns all 3 knees' warped maps and fields,
    bit-equal across ranks; in network mode within 1e-4 of JAX's sharded
    batch on a 2-device mesh, and with 2 fine-tuning steps equal to the
    port's unsharded batch in the same process. (JAX's sharded batch with
    fine-tuning is not a reference: Adam's first step, lr * g / |g|, takes
    the sign of reduction-order noise, so the JAX package's own test holds
    it to finite values alone; it moves this fixture's maps by up to 0.49
    from JAX's unsharded batch, which the port's agrees with to 1e-5.)"""
    from oai_analysis_2_tpu.core.image import image_from_array as jimage
    from oai_analysis_2_tpu.engine.segmenter import Segmenter3DInPatchClassWise as JSeg
    from oai_analysis_2_tpu.models.gradicon import GradICONConfig as JConfig
    from oai_analysis_2_tpu.parallel.batch import BatchKneePipeline as JBatch
    from oai_analysis_2_tpu.parallel.sharding import make_device_mesh as jmesh

    seg_config = json.loads((two_ranks / "seg_config.json").read_text())
    with np.load(two_ranks / "batch_inputs.npz") as z:
        knees, atlas = z["knees"], z["atlas"]
    net = _load_tree(two_ranks / "batch_net_params.npz")
    net = [net[f"stage{i}"] for i in range(len(BATCH_REG["scales"]))]
    jpipe = JBatch(JSeg("pred", dict(seg_config)), jimage(atlas, spacing=BATCH_SPACING), mesh=jmesh(n_data=2),
                   registration_config=JConfig(**BATCH_REG), registration_mode="network", finetune_steps=0,
                   max_batch_per_device=1)
    jpipe.registerer.load_params(net)
    want_w, want_d = jpipe.run_device_batch([jimage(k, spacing=BATCH_SPACING) for k in knees])
    ranks = _ranks_npz(two_ranks, "batch")
    assert len(ranks) == 2
    _same_on_every_rank(ranks, [f"finetune{s}/{k}" for s in (0, 2) for k in ("warped", "disp")])
    got = ranks[0]
    assert int(got["finetune0/n_devices"]) == 2 and int(got["finetune2/unsharded/n_devices"]) == 1
    assert got["finetune0/warped"].shape == want_w.shape == (3,) + knees.shape[1:] + (2,) and want_w.max() > 0.5
    assert got["finetune0/disp"].shape == want_d.shape == (3,) + BATCH_REG["grid_shape"] + (3,)
    np.testing.assert_allclose(got["finetune0/warped"], want_w, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["finetune0/disp"], want_d, atol=1e-4, rtol=0)
    assert np.abs(want_d).mean() > 0.05
    for key in ("warped", "disp"):
        np.testing.assert_array_equal(got[f"finetune2/{key}"], got[f"finetune2/unsharded/{key}"])
    assert np.abs(got["finetune2/disp"] - got["finetune0/disp"]).max() > 1e-3  # the fine-tuning moved the fields


def test_batch_pipeline_run_batch_every_rank_all_knees(two_ranks):
    """run_batch with thickness on 2 knees over 2 ranks: both ranks return
    both knees, bit-equal to each other, and each rank's own knee equals an
    unsharded run_batch of that knee alone in the same process."""
    ranks = _ranks_npz(two_ranks, "batch")
    assert [int(r["n_results"]) for r in ranks] == [2, 2]
    _same_on_every_rank(ranks, [k for k in ranks[0] if k.startswith("knee")])
    for rank, r in enumerate(ranks):
        for key in [k for k in r if k.startswith("alone/")]:
            np.testing.assert_array_equal(r[f"knee{rank}/" + key[len("alone/"):]], r[key], err_msg=key)
        assert len(r[f"knee{rank}/fc_inner/vertices"]) > 100


def test_cohort_under_the_process_group(two_ranks):
    """CohortRunner in both ranks with no `host`: the host index and count
    come from the group, each of the 4 items is done exactly once, and both
    ranks took items."""
    reports = [json.loads((two_ranks / f"cohort_rank{r}.json").read_text()) for r in range(2)]
    assert [(r["host"], r["n_hosts"]) for r in reports] == [(0, 2), (1, 2)]
    assert all(r["summary"]["done"] == 4 for r in reports)
    done = [item for r in reports for item in r["done"]]
    assert sorted(done) == [0, 1, 2, 3]
    assert all(r["done"] for r in reports)
