"""The PyTorch port on the release layout against the JAX package: the data
directory, `AnalysisObject()` from disk, the atlas probability maps,
`KneePipeline.run_path`, `engine.stages` and both CLI commands.

A release-shaped tree is written under `tmp_path` and `OAI_TPU_DATA_DIR`
points at it: `models/` holds a `UNet_light4` with threshold weights as the
reference's torch checkpoint (`ec*` / `dc*` names, written by the exact
inverse of the converter's transforms) and its training config;
`atlases/atlas_60_LEFT_baseline_NMI/` the atlas image and its FC / TC
probability maps. `urllib.request.urlretrieve` raises, so no test can reach
the network. The CLI's registration adapts to the shipped GradICON
checkpoint's recorded grid; tests point it at a copy of the shipped weights
recorded for a 16x32x32 grid (the stages are fully convolutional), which
keeps the network on the CPU to seconds.
"""

import json
import time
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu import __main__ as JMain
from oai_analysis_2_tpu.analysis_object import AnalysisObject as JAnalysis
from oai_analysis_2_tpu.core.nifti import read_nifti as jread
from oai_analysis_2_tpu.engine import stages as JStages
from oai_analysis_2_tpu.engine.atlas_products import AtlasThicknessMapper as JMapper
from oai_analysis_2_tpu.engine.pipeline import KneePipeline as JPipeline
from oai_analysis_2_tpu.models import gradicon as JG
from oai_analysis_2_tpu.utils import data as JData
from oai_analysis_2_tpu_torch import __main__ as TMain
from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject as TAnalysis
from oai_analysis_2_tpu_torch.core.image import image_from_array as timage
from oai_analysis_2_tpu_torch.core.nifti import read_nifti as tread
from oai_analysis_2_tpu_torch.core.nifti import write_nifti as twrite
from oai_analysis_2_tpu_torch.engine import registration as TReg
from oai_analysis_2_tpu_torch.engine import stages as TStages
from oai_analysis_2_tpu_torch.engine.atlas_products import AtlasThicknessMapper as TMapper
from oai_analysis_2_tpu_torch.engine.pipeline import KneePipeline as TPipeline
from oai_analysis_2_tpu_torch.mesh.types import Mesh
from oai_analysis_2_tpu_torch.models import gradicon as TG
from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS, make_threshold_params
from oai_analysis_2_tpu_torch.ops.resample import DisplacementField
from oai_analysis_2_tpu_torch.utils import data as TData
from oai_analysis_2_tpu_torch.utils.checkpoint import flatten_tree, load_checkpoint, save_checkpoint

torch.set_num_threads(2)

SHAPE = (32, 64, 64)
SPACING = (0.36, 0.36, 0.7)
GRID = (16, 32, 32)
MODEL = "UNet_light4"
ATLAS = "atlas_60_LEFT_baseline_NMI"


def _shell(shape, r_inner, r_outer, center):
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float32) for n in shape), indexing="ij")
    rr = np.sqrt(((z - center[0]) * 2.4) ** 2 + (y - center[1]) ** 2 + (x - center[2]) ** 2)
    shell = np.clip(1.0 - np.abs(rr - (r_inner + r_outer) / 2) / ((r_outer - r_inner) / 2), 0, 1)
    return (shell * (y < center[1])).astype(np.float32)


def _knee(shape, fc_center, tc_center, seed):
    """Two shells (the bench fixture's anatomy, scaled) over a noisy
    background, DESS-like intensities."""
    rng = np.random.default_rng(seed)
    s = shape[1] / 64.0
    anatomy = np.maximum(_shell(shape, 18.0 * s, 21.5 * s, fc_center), _shell(shape, 10.5 * s, 14.0 * s, tc_center))
    return (anatomy * 900.0 + rng.uniform(0.0, 250.0, shape)).astype(np.float32)


def _reference_state_dict(params: dict, n_dec: int) -> dict:
    """The reference's torch state_dict of a UNet tree: the exact inverse of
    the converter's transposes and flip."""
    sd = {}

    def put(name, p, kernel):
        sd[f"{name}.0.weight"] = torch.tensor(np.ascontiguousarray(kernel))
        if "bias" in p:
            sd[f"{name}.0.bias"] = torch.tensor(p["bias"])

    for key, p in params.items():
        k = p["kernel"]
        if key.startswith("enc"):
            li, half = int(key[3]), key[4]
            put(f"ec{2 * li + (half == 'b')}", p, np.transpose(k, (4, 3, 0, 1, 2)))
        elif key.startswith("dec"):
            li, part = int(key[3]), key[4:]
            base = 3 * (n_dec - li)
            if part == "up":
                put(f"dc{base}", p, np.transpose(k, (3, 4, 0, 1, 2)))
            else:
                put(f"dc{base - 1 if part == 'a' else base - 2}", p, np.transpose(k[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)))
        else:  # the 1x1x1 head
            sd["dc0.weight"] = torch.tensor(np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2))))
            sd["dc0.bias"] = torch.tensor(p["bias"])
    return sd


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    root = tmp_path_factory.mktemp("release")
    models = root / "data" / "models"
    models.mkdir(parents=True)
    spec = NETWORK_SPECS[MODEL].replace(bias=True)
    params = make_threshold_params(spec)
    torch.save({"model_state_dict": _reference_state_dict(params, len(spec.dec)), "epoch": 600},
               models / "segmentation_model.pth.tar")
    (models / "segmentation_train_config.pth.tar").write_text(json.dumps({
        "patch_size": [32, 32, 16], "model": MODEL,
        "model_setting": {"in_channels": 1, "n_classes": 2, "bias": True, "BN": False},
    }))
    atlas_dir = root / "data" / "atlases" / ATLAS
    atlas_dir.mkdir(parents=True)
    rng = np.random.default_rng(1)
    fc, tc = _shell(SHAPE, 18.0, 21.5, (16, 34, 31)), _shell(SHAPE, 10.5, 14.0, (16, 39, 31))
    atlas = (np.maximum(fc, tc) * 0.78 + rng.uniform(0.0, 0.22, SHAPE)).astype(np.float32)
    for name, vol in (("atlas_image", atlas), ("atlas_fc", fc), ("atlas_tc", tc)):
        twrite(timage(vol, spacing=SPACING, device="cpu"), atlas_dir / f"{name}.nii.gz")
    twrite(timage(_knee(SHAPE, (16, 35, 32), (16, 40, 32), 0), spacing=SPACING, device="cpu"), root / "knee.nii.gz")
    twrite(timage(_knee((48, 96, 96), (24, 53, 48), (24, 60, 48), 2), spacing=SPACING, device="cpu"),
           root / "knee48.nii.gz")
    # the shipped GradICON weights, recorded for the 16x32x32 grid
    state = load_checkpoint(TG.default_gradicon_weights_path())
    save_checkpoint(dict(state, grid_shape=list(GRID)), root / "gradicon16.npz")
    return root


@pytest.fixture
def env(release, monkeypatch):
    monkeypatch.setenv("OAI_TPU_DATA_DIR", str(release / "data"))

    def offline(*args, **kwargs):
        raise OSError("tests never reach the network")

    monkeypatch.setattr(urllib.request, "urlretrieve", offline)
    monkeypatch.setattr(time, "sleep", lambda s: None)  # the download's retry back-off
    for mod in (JG, TG, TReg):
        monkeypatch.setattr(mod, "default_gradicon_weights_path", lambda: release / "gradicon16.npz")
    return release


def test_data_dir_preseeded(env):
    assert TData.REGISTRY == JData.REGISTRY
    assert TData.data_dir() == JData.data_dir() == env / "data"
    assert TData.models_dir() == JData.models_dir() == env / "data" / "models"
    assert TData.atlases_dir() == JData.atlases_dir() == env / "data" / "atlases"
    with pytest.raises(RuntimeError, match="pre-seed"):
        TData.test_data_dir()  # not seeded: the (refused) download raises


def test_missing_release_raises(env, tmp_path, monkeypatch):
    """An empty data directory: both packages raise the same RuntimeError
    for the models and, given models, for the atlas."""
    monkeypatch.setenv("OAI_TPU_DATA_DIR", str(tmp_path))
    texts = []
    for make in (lambda **kw: TAnalysis(device="cpu", **kw), JAnalysis):
        with pytest.raises(RuntimeError) as models_err:
            make()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(RuntimeError) as atlas_err:
                make(models_path=env / "data" / "models")
        texts.append((str(models_err.value), str(atlas_err.value)))
    assert texts[0] == texts[1]
    assert "models tarball" in texts[0][0] and "atlas tarball" in texts[0][1]


def _objects(**kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return TAnalysis(device="cpu", **kw), JAnalysis(**kw)


def test_analysis_object_from_release(env, tmp_path):
    """The same atlas grid, atlas directory and segmenter parameters (read
    from the .pth.tar) in both packages; a models directory with only the
    .npz falls back to it."""
    tobj, jobj = _objects()
    assert tobj.atlas_dir == jobj.atlas_dir == env / "data" / "atlases" / ATLAS
    for k in ("data", "origin", "spacing", "direction"):
        np.testing.assert_array_equal(getattr(tobj.atlas_image, k).numpy(), np.asarray(getattr(jobj.atlas_image, k)))
    assert tobj.segmenter.config["ckpoint_path"] == jobj.segmenter.config["ckpoint_path"]
    assert tobj.segmenter.config["ckpoint_path"].endswith("segmentation_model.pth.tar")
    tobj.segmenter.pred_setup()
    jobj.segmenter.pred_setup()
    want = flatten_tree({k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jobj.segmenter.params.items()})
    got = {k.replace(".", "/"): v.numpy() for k, v in tobj.segmenter.model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tobj.segmenter.epoch == jobj.segmenter.epoch == 600

    npz_dir = tmp_path / "models"
    npz_dir.mkdir()
    save_checkpoint({"params": make_threshold_params(NETWORK_SPECS[MODEL].replace(bias=True)), "epoch": 3},
                    npz_dir / "segmentation_model.npz")
    (npz_dir / "segmentation_train_config.pth.tar").write_text(
        (env / "data" / "models" / "segmentation_train_config.pth.tar").read_text())
    tobj, _ = _objects(models_path=npz_dir)
    assert tobj.segmenter.config["ckpoint_path"].endswith("segmentation_model.npz")
    tobj.segmenter.pred_setup()
    assert tobj.segmenter.epoch == 3


def test_mapper_reads_atlas_maps(env):
    """With atlas_fc/tc.nii.gz in atlas_dir the mapper never segments (a
    spy segmenter raises), and its atlas meshes match the JAX mapper's."""

    class Spy:
        def segment(self, *args, **kwargs):
            raise AssertionError("the atlas was segmented")

    atlas_dir = env / "data" / "atlases" / ATLAS
    tatlas, jatlas = tread(atlas_dir / "atlas_image.nii.gz", device="cpu"), jread(atlas_dir / "atlas_image.nii.gz")
    tmap = TMapper.from_segmenter(Spy(), tatlas, atlas_dir=atlas_dir)
    jmap = JMapper.from_segmenter(Spy(), jatlas, atlas_dir=atlas_dir)
    for name in ("fc_atlas_inner", "tc_atlas_inner"):
        t, j = getattr(tmap, name), getattr(jmap, name)
        assert t.n_points > 500 and abs(t.n_points - j.n_points) <= 0.005 * j.n_points, name


@pytest.fixture(scope="module")
def run_paths(release, tmp_path_factory):
    """Both packages' run_path on the knee NIfTI, with atlas products from
    the atlas maps, network registration on the 16x32x32 grid."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OAI_TPU_DATA_DIR", str(release / "data"))
    try:
        kw = dict(overlap_size=(4, 4, 2), compute_dtype="float32", batch_size=2)
        tobj, jobj = _objects(**kw)
        calls = []
        segment = tobj.segmenter.segment
        tobj.segmenter.segment = lambda *a, **k: calls.append(1) or segment(*a, **k)
        out = tmp_path_factory.mktemp("run_path")
        metas = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for name, obj, pipe_cls, cfg, extra in (
                ("port", tobj, TPipeline, TG.GradICONConfig(grid_shape=GRID, stage_width=24), dict(device="cpu")),
                ("jax", jobj, JPipeline, JG.GradICONConfig(grid_shape=GRID, stage_width=24), {}),
            ):
                pipe = pipe_cls(obj.segmenter, obj.atlas_image, registration_config=cfg, registration_mode="network",
                                atlas_products=True, atlas_dir=obj.atlas_dir, **extra)
                metas[name] = pipe.run_path(release / "knee.nii.gz", output_dir=out / name)
    finally:
        mp.undo()
    return out, metas, len(calls)


def test_run_path_files_and_metadata(run_paths):
    out, metas, segment_calls = run_paths
    assert segment_calls == 1  # the knee; the atlas meshes came from its maps
    names = {p.name for p in (out / "port").iterdir()}
    assert names == {p.name for p in (out / "jax").iterdir()}
    assert names == {f"knee_{t}_{s}.vtk" for t in ("FC", "TC") for s in ("inner", "outer")} | {"knee_thickness_2d.npz"}
    got, want = metas["port"], metas["jax"]
    assert set(got) == set(want) | {"read_seconds", "write_seconds"}
    assert got["read_seconds"] >= 0 and got["write_seconds"] > 0
    assert set(got["timings"]) == set(want["timings"])
    assert got["input"] == want["input"] and got["thickness_2d"].endswith("knee_thickness_2d.npz")
    for k in ("fc_points", "tc_points"):
        assert want[k] > 500 and abs(got[k] - want[k]) <= 0.005 * want[k], k
    for k in ("fc_raster_coverage", "tc_raster_coverage"):
        assert got[k] == want[k] > 0, k
    for k in ("fc_mean_thickness_mm", "tc_mean_thickness_mm"):
        assert abs(got[k] - want[k]) <= 1e-3, k
    with np.load(out / "port" / "knee_thickness_2d.npz") as t, np.load(out / "jax" / "knee_thickness_2d.npz") as j:
        assert set(t.files) == set(j.files)


def test_run_path_meshes_read_back(run_paths):
    """The VTK files read back with the sizes of the JAX package's, mean
    thickness within 1e-3 mm (tests/test_torch_pipeline.py's tolerances)."""
    out, _, _ = run_paths
    for t in ("FC", "TC"):
        for s in ("inner", "outer"):
            got, want = (Mesh.load_vtk(out / w / f"knee_{t}_{s}.vtk") for w in ("port", "jax"))
            assert want.n_points > 500 and abs(got.n_points - want.n_points) <= 0.005 * want.n_points
            assert abs(float(got.point_data.mean()) - float(want.point_data.mean())) <= 1e-3


def test_stages_match(env):
    """image_normalize, readimage, deform_probmap and get_thickness against
    the JAX stages on the same files. register_images (instance
    optimization, one step a scale on the 16x32x32 grid, lr 1.2 voxels a
    step) is held statistically: median field gap under 1e-3 mm and 90th
    percentile under 0.01 mm of a field of about 1.3 mm. Elements whose
    gradient is rounding noise move a whole Adam step either way, and the
    next scale starts from those (tests/test_torch_instance.py)."""
    knee, atlas_dir = env / "knee.nii.gz", env / "data" / "atlases" / ATLAS
    t_img, j_img = TStages.readimage(knee, device="cpu"), JStages.readimage(knee)
    np.testing.assert_array_equal(t_img.data.numpy(), np.asarray(j_img.data))
    np.testing.assert_allclose(TStages.image_normalize(t_img).data.numpy(),
                               np.asarray(JStages.image_normalize(j_img).data), atol=1e-6)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        TStages.readimage("s3://bucket/knee.zarr")

    atlas = atlas_dir / "atlas_image.nii.gz"
    tphi, _, _ = TStages.register_images(knee, atlas, config=TG.GradICONConfig(grid_shape=GRID),
                                         instance_steps=1, device="cpu")
    jphi, _, _ = JStages.register_images(knee, atlas, config=JG.GradICONConfig(grid_shape=GRID), instance_steps=1)
    gap = np.abs(tphi.field.numpy() - np.asarray(jphi.field))
    assert float(np.abs(np.asarray(jphi.field)).mean()) > 0.5
    assert float(np.median(gap)) < 1e-3 and float(np.percentile(gap, 90)) < 0.01

    # warp the atlas FC map through the JAX field in both packages
    phi = DisplacementField(*(torch.tensor(np.asarray(getattr(jphi, k))) for k in ("field", "origin", "spacing",
                                                                                   "direction")))
    t_fc, j_fc = tread(atlas_dir / "atlas_fc.nii.gz", device="cpu"), jread(atlas_dir / "atlas_fc.nii.gz")
    t_w = TStages.deform_probmap(phi, t_img, t_img, t_fc)
    j_w = JStages.deform_probmap(jphi, j_img, j_img, j_fc)
    np.testing.assert_allclose(t_w.data.numpy(), np.asarray(j_w.data), atol=1e-4)

    t_in, j_in = TStages.get_thickness(t_fc, "FC"), JStages.get_thickness(j_fc, "FC")
    assert j_in.n_points > 500 and abs(t_in.n_points - j_in.n_points) <= 0.005 * j_in.n_points
    assert abs(float(t_in.point_data.mean()) - float(np.mean(j_in.point_data))) <= 1e-3


def test_segment_method_and_cli_segment_match(env, tmp_path):
    """segment_method and `main(["segment", ...])` of both packages (the
    release's bf16 defaults) write probability maps within 2e-2."""
    knee, models = env / "knee.nii.gz", env / "data" / "models"
    t_fc, t_tc = TStages.segment_method(knee, models, device="cpu")
    j_fc, j_tc = JStages.segment_method(knee, models)
    for t, j in ((t_fc, j_fc), (t_tc, j_tc)):
        assert float(np.asarray(j.data).max()) > 0.5
        np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data), atol=2e-2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        TMain.main(["segment", str(knee), "-o", str(tmp_path / "port"), "--device", "cpu"])
        JMain.main(["segment", str(knee), "-o", str(tmp_path / "jax")])
    for name in ("FC_probmap.nii.gz", "TC_probmap.nii.gz"):
        got, want = tread(tmp_path / "port" / name, device="cpu"), jread(tmp_path / "jax" / name)
        assert float(np.asarray(want.data).max()) > 0.5
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), atol=2e-2)
        np.testing.assert_allclose(got.spacing.numpy(), np.asarray(want.spacing), atol=1e-6)


def test_cli_pipeline(env, tmp_path):
    """`main(["pipeline", ...])` on a 48x96x96 knee: network registration
    without fine-tuning; the four meshes and the metadata are written. The
    unported commands are not offered."""
    out = tmp_path / "out"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        meta = TMain.main(["pipeline", str(env / "knee48.nii.gz"), "-o", str(out), "--registration-mode", "network",
                           "--finetune-steps", "0", "--device", "cpu"])
    assert {p.name for p in out.iterdir()} == {f"knee48_{t}_{s}.vtk" for t in ("FC", "TC") for s in ("inner", "outer")}
    assert {"input", "timings", "fc_points", "tc_points", "registration_quality", "outputs", "read_seconds",
            "write_seconds"} == set(meta)
    assert meta["fc_points"] > 0 and meta["tc_points"] > 0
    assert Mesh.load_vtk(out / "knee48_FC_inner.vtk").n_points == meta["fc_points"]
    for cmd in ("cohort", "bench", "prewarm"):
        with pytest.raises(SystemExit):
            TMain.main([cmd, str(tmp_path)])


def test_cli_needs_a_card_by_default(env, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TMain.main(["segment", str(env / "knee.nii.gz"), "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tread(env / "knee.nii.gz")

