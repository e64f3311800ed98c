"""The PyTorch port's whole slice against the JAX package, and its device
and import rules.

Both `KneePipeline.run`s see the same small phantom knee and atlas (the
bench fixture's two shells on a 32x64x64 grid), the same threshold
weights on a narrow UNet and the shipped width-24 GradICON weights on a
(16, 32, 32) registration grid: the warped probability maps, the mesh sizes
and the mean thicknesses are compared, in network mode and, with the atlas
thickness maps, in instance mode and network + fine-tune mode.
"""

import ast
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu.core.image import image_from_array as jimage
from oai_analysis_2_tpu.engine.atlas_products import thickness_map_stats as JStats
from oai_analysis_2_tpu.engine.pipeline import KneePipeline as JPipeline
from oai_analysis_2_tpu.engine.segmenter import Segmenter3DInPatchClassWise as JSeg
from oai_analysis_2_tpu.models.gradicon import GradICONConfig as JConfig
from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject
from oai_analysis_2_tpu_torch.core import device as tdevice
from oai_analysis_2_tpu_torch.core.image import image_from_array as timage
from oai_analysis_2_tpu_torch.engine.atlas_products import thickness_map_stats as TStats
from oai_analysis_2_tpu_torch.engine.pipeline import KneePipeline as TPipeline
from oai_analysis_2_tpu_torch.engine.registration import ICON_Registration
from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise as TSeg
from oai_analysis_2_tpu_torch.models.gradicon import GradICONConfig as TConfig
from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS, make_threshold_params
from oai_analysis_2_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (32, 64, 64)
SPACING = (0.36, 0.36, 0.7)
GRID = (16, 32, 32)


def _shell(r_inner, r_outer, center):
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float32) for n in SHAPE), indexing="ij")
    rr = np.sqrt(((z - center[0]) * 2.4) ** 2 + (y - center[1]) ** 2 + (x - center[2]) ** 2)
    shell = np.clip(1.0 - np.abs(rr - (r_inner + r_outer) / 2) / ((r_outer - r_inner) / 2), 0, 1)
    return (shell * (y < center[1])).astype(np.float32)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(0)
    knee = np.maximum(_shell(18.0, 21.5, (16, 35, 32)), _shell(10.5, 14.0, (16, 40, 32)))
    knee = (knee * 900.0 + rng.uniform(0.0, 250.0, SHAPE)).astype(np.float32)
    atlas = np.maximum(_shell(18.0, 21.5, (16, 34, 31)), _shell(10.5, 14.0, (16, 39, 31)))
    atlas = (atlas * 0.78 + rng.uniform(0.0, 0.22, SHAPE)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("torch_pipeline")
    (tmp / "cfg.json").write_text(json.dumps({
        "patch_size": [32, 32, 16], "model": "UNet_light4",
        "model_setting": {"in_channels": 1, "n_classes": 2, "bias": True, "BN": False},
    }))
    params = make_threshold_params(NETWORK_SPECS["UNet_light4"].replace(bias=True))
    save_checkpoint({"params": params, "epoch": 1}, False, tmp, name="seg.npz")
    config = {"ckpoint_path": str(tmp / "seg.npz"), "training_config_file": str(tmp / "cfg.json"),
              "batch_size": 2, "overlap_size": (4, 4, 2), "compute_dtype": "float32"}
    return knee, atlas, config


@pytest.fixture(scope="module")
def results(inputs):
    knee, atlas, config = inputs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jpipe = JPipeline(JSeg("pred", dict(config)), jimage(atlas, spacing=SPACING),
                          registration_config=JConfig(grid_shape=GRID, stage_width=24), finetune_steps=0)
        tpipe = TPipeline(TSeg("pred", dict(config, device="cpu")), timage(atlas, spacing=SPACING, device="cpu"),
                          registration_config=TConfig(grid_shape=GRID, stage_width=24), device="cpu")
    assert jpipe.registerer.mode == tpipe.registerer.mode == "network"
    return (jpipe.run(jimage(knee, spacing=SPACING)),
            tpipe.run(timage(knee, spacing=SPACING, device="cpu")))


def test_warped_probmaps_match(results):
    want, got = results
    for name in ("fc_probmap", "tc_probmap"):
        w, g = np.asarray(getattr(want, name).data), getattr(got, name).data.numpy()
        assert g.shape == w.shape == SHAPE and w.max() > 0.5
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def test_meshes_and_thickness_match(results):
    """Mesh sizes within 0.5 % and mean thickness within 1e-3 mm: a face whose
    centroid sits at a femoral band edge may change side (test_torch_mesh)."""
    want, got = results
    for name in ("fc_inner", "fc_outer", "tc_inner", "tc_outer"):
        w, g = getattr(want, name), getattr(got, name)
        assert w.n_points > 1000, name
        assert abs(g.n_points - w.n_points) <= 0.005 * w.n_points, (name, g.n_points, w.n_points)
        assert abs(float(np.mean(g.point_data)) - float(np.mean(w.point_data))) <= 1e-3, name


def test_stage_report_and_quality(results):
    want, got = results
    assert set(got.timings) == {"preprocess", "segment", "register", "warp", "thickness"}
    assert set(got.registration_quality) == set(want.registration_quality)
    for k, v in want.registration_quality.items():
        assert abs(got.registration_quality[k] - v) <= 1e-3, k


@pytest.fixture(scope="module", params=["instance", "finetune"])
def atlas_results(request, inputs):
    """Both packages' KneePipeline with atlas products, registering by
    instance optimization (the default schedule) or by the network plus 3
    fine-tuning steps."""
    knee, atlas, config = inputs
    mode = dict(instance=dict(registration_mode="instance"),
                finetune=dict(registration_mode="network", finetune_steps=3))[request.param]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jpipe = JPipeline(JSeg("pred", dict(config)), jimage(atlas, spacing=SPACING),
                          registration_config=JConfig(grid_shape=GRID, stage_width=24), atlas_products=True, **mode)
        tpipe = TPipeline(TSeg("pred", dict(config, device="cpu")), timage(atlas, spacing=SPACING, device="cpu"),
                          registration_config=TConfig(grid_shape=GRID, stage_width=24), atlas_products=True,
                          device="cpu", **mode)
    assert jpipe.registerer.mode == tpipe.registerer.mode == mode["registration_mode"]
    return (request.param, jpipe.run(jimage(knee, spacing=SPACING)),
            tpipe.run(timage(knee, spacing=SPACING, device="cpu")))


# stated tolerances per registration: the network + fine-tune maps agree to
# f32 rounding, so the slice is held as tightly as the network-only slice;
# instance optimization from the identity with the default schedule (lr 1.2
# voxels a step) on this 16x32x32 grid folds about 30 % of both packages'
# maps, and runs that far from convergence are not close element by
# element (tests/test_torch_instance.py), so that slice is held to 10 % in
# mesh size and mean thickness, 0.05 in fold fraction and 15 % in
# inverse-consistency error
SLICE_TOL = {
    "finetune": dict(points=0.005, thickness=1e-3, relative=False, folds=1e-3, ice=1e-3),
    "instance": dict(points=0.10, thickness=0.10, relative=True, folds=0.05, ice=0.15),
}


def _close(got, want, tol, relative):
    return abs(got - want) <= (tol * abs(want) if relative else tol)


def test_atlas_slice_matches(atlas_results):
    mode, want, got = atlas_results
    tol = SLICE_TOL[mode]
    assert set(got.timings) == {"preprocess", "segment", "register", "warp", "thickness", "atlas_map"}
    for name in ("fc_inner", "fc_outer", "tc_inner", "tc_outer"):
        w, g = getattr(want, name), getattr(got, name)
        assert w.n_points > 1000, name
        assert abs(g.n_points - w.n_points) <= tol["points"] * w.n_points, (name, g.n_points, w.n_points)
        assert _close(float(np.mean(g.point_data)), float(np.mean(w.point_data)), tol["thickness"],
                      tol["relative"]), name
    wq, gq = want.registration_quality, got.registration_quality
    assert set(gq) == set(wq)
    for k in ("fold_fraction_ab", "fold_fraction_ba"):
        assert abs(gq[k] - wq[k]) <= tol["folds"], (k, gq[k], wq[k])
    assert _close(gq["ice_mean_vox"], wq["ice_mean_vox"], tol["ice"], mode == "instance")


def test_atlas_maps_match(atlas_results):
    """The thickness maps: the atlas embedding (the same atlas segmented
    and smoothed by each package, whose vertices agree to about 6e-6 mm)
    within 1e-4, raster coverage equal, mean mapped thickness within
    the slice's thickness tolerance."""
    mode, want, got = atlas_results
    tol = SLICE_TOL[mode]
    w2, g2 = want.thickness_2d, got.thickness_2d
    assert set(g2) == set(w2)
    for k in w2:
        assert g2[k].shape == w2[k].shape, k
        if k.endswith(("_x", "_y", "_bounds")):
            np.testing.assert_allclose(g2[k], w2[k], atol=1e-4, err_msg=k)
    ws, gs = JStats(w2), TStats(g2)
    for name in ("fc", "tc"):
        assert gs[f"{name}_raster_coverage"] == ws[f"{name}_raster_coverage"] > 0
        assert _close(gs[f"{name}_mean_thickness_mm"], ws[f"{name}_mean_thickness_mm"], tol["thickness"],
                      tol["relative"]), name


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_card_or_an_explicit_cpu(no_card, inputs):
    _, atlas, config = inputs
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TSeg("pred", dict(config))
    with pytest.raises(RuntimeError, match="CUDA"):
        timage(atlas)
    with pytest.raises(RuntimeError, match="CUDA"):
        ICON_Registration(mode="network")
    with pytest.raises(RuntimeError, match="CUDA"):
        AnalysisObject.offline(atlas_shape="phantom:16,32,32")
    seg = TSeg("pred", dict(config, device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="CUDA"):
            TPipeline(seg, timage(atlas, spacing=SPACING, device="cpu"),
                      registration_config=TConfig(grid_shape=GRID, stage_width=24))
        pipe = TPipeline(seg, timage(atlas, spacing=SPACING, device="cpu"),
                         registration_config=TConfig(grid_shape=GRID, stage_width=24), device="cpu")
    assert pipe.device.type == "cpu"
    assert tdevice.resolve_device("cpu").type == "cpu"


def test_unported_registration_modes_raise():
    """Instance optimization and fine-tuning are ported: both modes build
    their registerer; an unknown mode still raises."""
    atlas = timage(np.zeros((4, 4, 4), np.float32), device="cpu")
    assert TPipeline(None, atlas, registration_mode="instance", device="cpu").registerer.mode == "instance"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = TPipeline(None, atlas, registration_mode="network", finetune_steps=3, device="cpu")
    assert pipe.registerer.mode == "network" and pipe.registerer.finetune_steps == 3
    with pytest.raises(ValueError, match="unknown registration mode"):
        TPipeline(None, atlas, registration_mode="bogus", device="cpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or the JAX
    package (including imports inside functions)."""
    files = sorted((ROOT / "oai_analysis_2_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "oai_analysis_2_tpu"), (path, name)
