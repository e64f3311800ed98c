"""The port's phantom full demo (`oai_analysis_2_tpu_torch/examples/
full_demo.py`) on the CPU, the whole demo port only: the JAX script takes minutes at any
size where its phantom works (`tools/port_full_demo_parity.py` holds the
two packages there, and the stage functions are held against the JAX
package by the other `test_torch_*` files). Its `_phantom_setup` is
replaced by a 32x64x64 object (a threshold `UNet_light4` in place of the
offline production UNet) whose atlas and knee have shells thick enough to
survive the 3000-cell filter, and its output is held against the same
stage functions called directly. The stages after the warp are also held
against the JAX package's on a map that JAX warped.
"""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oai_analysis_2_tpu.core.image import image_from_array as jimage
from oai_analysis_2_tpu.mesh import processing as JP
from oai_analysis_2_tpu.ops.resample import DisplacementField as JField
from oai_analysis_2_tpu.ops.resample import resample_image as jwarp
from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject
from oai_analysis_2_tpu_torch.core.image import image_from_array
from oai_analysis_2_tpu_torch.core.nifti import read_nifti
from oai_analysis_2_tpu_torch.engine.registration import ICON_Registration
from oai_analysis_2_tpu_torch.examples import full_demo as TFull
from oai_analysis_2_tpu_torch.mesh.ops import map_attributes
from oai_analysis_2_tpu_torch.mesh.processing import get_mesh, get_thickness_mesh, split_mesh
from oai_analysis_2_tpu_torch.mesh.projection import project_thickness, rasterize_thickness
from oai_analysis_2_tpu_torch.mesh.types import Mesh
from oai_analysis_2_tpu_torch.models.gradicon import GradICONConfig
from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS, make_threshold_params
from oai_analysis_2_tpu_torch.ops.intensity import checkerboard, percentile_window
from oai_analysis_2_tpu_torch.ops.resample import resample_image
from oai_analysis_2_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_release import SHAPE, SPACING, _knee, _shell

torch.set_num_threads(2)


def small_phantom_setup(calls, models_dir):
    """`_phantom_setup` at 32x64x64: an `AnalysisObject` like the offline
    one, with a threshold `UNet_light4` (f32) from `models_dir` in place of
    the production UNet (which takes tens of seconds a volume on the CPU),
    an atlas of two thick shells, the shipped GradICON on a 16x32x32 grid,
    and the release fixture's knee; `calls` records what the object's
    segment and register returned."""
    spec = NETWORK_SPECS["UNet_light4"].replace(bias=True)
    save_checkpoint({"params": make_threshold_params(spec), "epoch": 1}, False, models_dir,
                    name="segmentation_model.npz")
    (models_dir / "segmentation_train_config.pth.tar").write_text(json.dumps({
        "patch_size": [32, 32, 16], "model": "UNet_light4",
        "model_setting": {"in_channels": 1, "n_classes": 2, "bias": True, "BN": False}}))

    def setup(device):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            obj = AnalysisObject(models_path=models_dir, atlas_path="phantom:32,64,64", device=device,
                                 compute_dtype="float32")
        rng = np.random.default_rng(1)
        atlas = np.maximum(_shell(SHAPE, 18.0, 21.5, (16, 34, 31)), _shell(SHAPE, 10.5, 14.0, (16, 39, 31)))
        obj.atlas_image = image_from_array((atlas * 0.78 + rng.uniform(0.0, 0.22, SHAPE)).astype(np.float32),
                                           spacing=SPACING, device=device)
        obj.registerer = ICON_Registration(mode="network", config=GradICONConfig(grid_shape=(16, 32, 32),
                                                                                 stage_width=24), device=device)
        for name in ("segment", "register"):
            def spy(image, _f=getattr(obj, name), _name=name):
                out = _f(image)
                calls.setdefault(_name, []).append((image, out))
                return out
            setattr(obj, name, spy)
        knee = image_from_array(_knee(SHAPE, (16, 35, 32), (16, 40, 32), 0), spacing=SPACING, device=device)
        return obj, percentile_window(knee)

    return setup


def test_full_demo_phantom_matches_its_stages(tmp_path, monkeypatch, capsys):
    """The printed lines, the files, the npz keys and arrays and the stage
    report of `full_demo.main(["phantom", dir])` against the stage functions
    called directly on what its segment and register returned."""
    calls = {}
    (tmp_path / "models").mkdir()
    monkeypatch.setattr(TFull, "_phantom_setup", small_phantom_setup(calls, tmp_path / "models"))
    out = tmp_path / "full"
    capsys.readouterr()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = TFull.main(["phantom", str(out)], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()

    (image, (fc_prob, tc_prob)), (atlas, (afc, atc)) = calls["segment"]
    (_, phi), = calls["register"]
    assert atlas.data is not image.data and tuple(atlas.shape) == SHAPE
    fc_w = resample_image(fc_prob, atlas, displacement=phi)
    tc_w = resample_image(tc_prob, atlas, displacement=phi)
    board = checkerboard(resample_image(percentile_window(image), atlas, displacement=phi), atlas)
    (fc_inner, _), (tc_inner, _) = get_thickness_mesh(fc_w, "FC"), get_thickness_mesh(tc_w, "TC")
    want_lines, arrays = [], {}
    for t, inner, atlas_p in (("FC", fc_inner, afc), ("TC", tc_inner, atc)):
        assert inner.n_points > 0
        want_lines.append(f"{t} mesh: {inner.n_points} pts, mean thickness {float(np.mean(inner.point_data)):.3f}")
        mapped = map_attributes(inner, split_mesh(get_mesh(atlas_p), t)[0], device="cpu")
        x, y, th = project_thickness(mapped, t)
        m, c, b = rasterize_thickness(x, y, th)
        arrays.update({f"{t.lower()}_x": x, f"{t.lower()}_y": y, f"{t.lower()}_thickness": th,
                       f"{t.lower()}_map": m, f"{t.lower()}_counts": c, f"{t.lower()}_bounds": np.asarray(b)})
    for t in ("FC", "TC"):
        m, c = arrays[f"{t.lower()}_map"], arrays[f"{t.lower()}_counts"]
        want_lines.append(f"{t} 2D atlas raster: coverage {float((c > 0).mean()):.1%}, "
                          f"mean thickness {float(m[c > 0].mean()):.3f} mm")
    assert lines[:4] == want_lines

    try:
        import matplotlib  # noqa: F401

        pngs = {"thickness_FC.png", "thickness_TC.png"}
    except ImportError:
        pngs = set()
    assert {p.name for p in out.iterdir()} == set(TFull.OUTPUT_FILES) | pngs
    with np.load(out / "thickness_2d.npz") as z:
        assert set(z.files) == set(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    for name, want in (("FC_probmap_atlas", fc_w), ("TC_probmap_atlas", tc_w), ("registration_checkerboard", board)):
        np.testing.assert_allclose(read_nifti(out / f"{name}.nii.gz", device="cpu").numpy(), want.numpy(), atol=1e-6, err_msg=name)
    for t, inner in (("FC", fc_inner), ("TC", tc_inner)):
        back = Mesh.load_vtk(out / f"{t}_inner_thickness.vtk")
        assert back.n_points == inner.n_points
    assert set(got["stages"]) == {"segment", "register", "warp", "thickness", "atlas_map", "project"}
    assert got["fc_points"] == fc_inner.n_points and got["tc_points"] == tc_inner.n_points
    assert 0.2 < got["fc_median_thickness"] < 10.0 and got["fc_coverage"] > 0 and got["tc_coverage"] > 0


@pytest.mark.parametrize("tissue", ["FC", "TC"])
def test_stages_after_the_warp_match_jax(tissue):
    """The hand-off after the warp at 32x64x64: a map warped by the JAX
    package (the knee's shell onto the atlas grid by a smooth field) through
    the port's `get_thickness_mesh` -> `map_attributes` ->
    `project_thickness` -> `rasterize_thickness`, against the JAX chain on
    the same map and the JAX atlas mesh; then the port's raster stages on
    the JAX meshes, which must give the JAX raster exactly."""
    radii, knee_c, atlas_c = {"FC": ((18.0, 21.5), (16, 35, 32), (16, 34, 31)),
                              "TC": ((10.5, 14.0), (16, 40, 32), (16, 39, 31))}[tissue]
    atlas = jimage(_shell(SHAPE, *radii, atlas_c), spacing=SPACING)
    knee = jimage(_shell(SHAPE, *radii, knee_c), spacing=SPACING)
    g = np.stack(np.meshgrid(*(np.linspace(0.0, np.pi, n, dtype=np.float32) for n in (8, 16, 16)),
                             indexing="ij"), -1)
    field = (np.float32([0.25, -0.3, 0.2]) + 0.3 * np.sin(g[..., ::-1] * np.float32([1.0, 2.0, 1.5]))).astype(np.float32)
    spacing = np.float32(SPACING) * (np.float32(SHAPE[::-1]) - 1) / (np.float32([16, 16, 8]) - 1)
    phi = JField(jnp.asarray(field), jnp.zeros(3, jnp.float32), jnp.asarray(spacing), jnp.eye(3, dtype=jnp.float32))
    warped = jwarp(knee, atlas, displacement=phi)

    j_inner, _ = JP.get_thickness_mesh(warped, mesh_type=tissue)
    j_atlas, _ = JP.split_mesh(JP.get_mesh(atlas), mesh_type=tissue)
    want = JP.rasterize_thickness(*JP.project_thickness(JP.map_attributes(j_inner, j_atlas), mesh_type=tissue))

    t_warped = image_from_array(np.array(warped.data), spacing=SPACING, device="cpu")
    inner, _ = get_thickness_mesh(t_warped, tissue)
    assert inner.n_points == j_inner.n_points > 500
    np.testing.assert_allclose(inner.vertices, j_inner.vertices, atol=1e-4, rtol=0)
    np.testing.assert_allclose(inner.point_data, j_inner.point_data, atol=1e-3, rtol=0)
    t_atlas = Mesh(j_atlas.vertices, j_atlas.faces)
    got = rasterize_thickness(*project_thickness(map_attributes(inner, t_atlas, device="cpu"), tissue))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-3, rtol=0)
    # the raster stages alone, on the JAX meshes: exact
    exact = rasterize_thickness(*project_thickness(
        map_attributes(Mesh(j_inner.vertices, j_inner.faces, j_inner.point_data), t_atlas, device="cpu"), tissue))
    for a, b in zip(exact, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
