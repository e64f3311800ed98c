"""The PyTorch port's whole slice against the JAX package, and its device
and import rules.

Both `KneePipeline.run`s see the same small phantom knee and atlas (the
bench fixture's two shells on a 32x64x64 grid), the same threshold
weights on a narrow UNet and the shipped width-24 GradICON weights on a
(16, 32, 32) registration grid: the warped probability maps, the mesh sizes
and the mean thicknesses are compared.
"""

import ast
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu.core.image import image_from_array as jimage
from oai_analysis_2_tpu.engine.pipeline import KneePipeline as JPipeline
from oai_analysis_2_tpu.engine.segmenter import Segmenter3DInPatchClassWise as JSeg
from oai_analysis_2_tpu.models.gradicon import GradICONConfig as JConfig
from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject
from oai_analysis_2_tpu_torch.core import device as tdevice
from oai_analysis_2_tpu_torch.core.image import image_from_array as timage
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
    save_checkpoint({"params": params, "epoch": 1}, tmp / "seg.npz")
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
    with pytest.raises(NotImplementedError, match="not ported"):
        TPipeline(None, timage(np.zeros((4, 4, 4), np.float32), device="cpu"),
                  registration_mode="instance", device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        TPipeline(None, timage(np.zeros((4, 4, 4), np.float32), device="cpu"),
                  registration_mode="network", finetune_steps=3, device="cpu")


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
