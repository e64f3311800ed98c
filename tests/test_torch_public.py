"""The small public functions of ported modules against the JAX package:
intensity normalisation and comparison, sampling at physical points, the
mesh helpers of `mesh/processing.py`, `ParameterDict`, the profiler trace,
the segmenter's Dice evaluation and its one-knee `volume_fn`, and the
JAX-style calls the API audit (`test_torch_api_parity.py`) found refused:
`distance_to_surface_async`, `make_threshold_params(model)`,
`project_thickness(..., embedded=)`, `StageTimer.stage(name, sync=)`. Same
seeded numpy inputs, on the CPU, tolerances stated per test."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oai_analysis_2_tpu.core.image import image_from_array as jimage
from oai_analysis_2_tpu.engine.segmenter import Segmenter3DInPatchClassWise as JSeg
from oai_analysis_2_tpu.mesh import ops as JO
from oai_analysis_2_tpu.mesh import processing as JP
from oai_analysis_2_tpu.mesh import projection as JPJ
from oai_analysis_2_tpu.ops import intensity as JN
from oai_analysis_2_tpu.ops import resample as JRS
from oai_analysis_2_tpu.utils.config import ParameterDict as JParams
from oai_analysis_2_tpu_torch.core.image import image_from_array as timage
from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise as TSeg
from oai_analysis_2_tpu_torch.mesh import ops as TO
from oai_analysis_2_tpu_torch.mesh import processing as TP
from oai_analysis_2_tpu_torch.mesh import projection as TPJ
from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS, UNet3D, make_threshold_params
from oai_analysis_2_tpu_torch.ops import intensity as TN
from oai_analysis_2_tpu_torch.ops import resample as TRS
from oai_analysis_2_tpu_torch.utils.checkpoint import save_checkpoint
from oai_analysis_2_tpu_torch.utils.config import ParameterDict as TParams
from oai_analysis_2_tpu_torch.utils.profiling import StageTimer, trace

torch.set_num_threads(2)

META = dict(origin=(1.5, -2.0, 3.25), spacing=(0.36, 0.4, 0.7),
            direction=np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32))


def _pair(data, **meta):
    return timage(data, device="cpu", **meta), jimage(data, **meta)


def test_intensity_functions_match():
    """normalize_image and comparison_sum within f32 rounding of the JAX
    sums (1e-5 relative), checkerboard exactly, odd shapes and patterns."""
    rng = np.random.default_rng(0)
    a = rng.normal(300, 80, (9, 10, 11)).astype(np.float32)
    b = rng.normal(310, 70, (9, 10, 11)).astype(np.float32)
    (ta, ja), (tb, jb) = _pair(a, **META), _pair(b, **META)
    np.testing.assert_allclose(TN.normalize_image(ta).data.numpy(), np.asarray(JN.normalize_image(ja).data),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(TN.comparison_sum(ta, tb)), float(JN.comparison_sum(ja, jb)), rtol=1e-5)
    for pattern in ((4, 4, 4), (3, 2, 5)):
        np.testing.assert_array_equal(TN.checkerboard(ta, tb, pattern).data.numpy(),
                                      np.asarray(JN.checkerboard(ja, jb, pattern).data))
    flat = timage(np.full((2, 2, 2), 5.0, np.float32), device="cpu")
    assert torch.isfinite(TN.normalize_image(flat).data).all()


def test_sampling_functions_match():
    """sample_at_physical_points (points inside, on and outside the buffer)
    and resample_with_displacement within 1e-5."""
    rng = np.random.default_rng(1)
    vol = rng.uniform(0, 1, (8, 9, 10)).astype(np.float32)
    timg, jimg = _pair(vol, **META)
    idx = rng.uniform(-1.5, 10.5, (200, 3)).astype(np.float32)
    pts = np.asarray(jimg.indices_to_physical(jnp.asarray(idx)))
    got = TRS.sample_at_physical_points(timg, torch.tensor(pts), outside_value=-1.0).numpy()
    want = np.asarray(JRS.sample_at_physical_points(jimg, jnp.asarray(pts), outside_value=-1.0))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (want == -1.0).any() and (want != -1.0).any()

    field = rng.normal(0, 0.3, (4, 5, 5, 3)).astype(np.float32)
    disp_meta = dict(origin=np.asarray(META["origin"], np.float32), spacing=np.asarray((0.9, 0.8, 1.75), np.float32),
                     direction=META["direction"])
    tdisp = TRS.DisplacementField(*(torch.tensor(np.asarray(v)) for v in (field, *disp_meta.values())))
    jdisp = JRS.DisplacementField(jnp.asarray(field), *(jnp.asarray(v) for v in disp_meta.values()))
    got = TRS.resample_with_displacement(timg, tdisp, timg).data.numpy()
    want = np.asarray(JRS.resample_with_displacement(jimg, jdisp, jimg).data)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _ball(n=24, r=8.0, center=(12, 11, 12)):
    z, y, x = np.meshgrid(*[np.arange(n, dtype=np.float32)] * 3, indexing="ij")
    rr = np.sqrt((z - center[0]) ** 2 + (y - center[1]) ** 2 + (x - center[2]) ** 2)
    return np.clip(1.0 - (rr - r), 0.0, 1.0).astype(np.float32)


def _shell_cap(n=32):
    z, y, x = np.meshgrid(*[np.arange(n, dtype=np.float32)] * 3, indexing="ij")
    c = n / 2.0
    rr = np.sqrt((z - c) ** 2 + (y - c) ** 2 + (x - c) ** 2)
    return (np.clip(1.0 - np.abs(rr - 11.0) / 2.0, 0.0, 1.0) * (y < c - 2)).astype(np.float32)


def test_mesh_helpers_match():
    """get_mesh_from_probability_map ("mc"): the same vertices (sorted,
    within 1e-5 mm) and faces counts; get_cell_centroid / get_cell_normals
    within 1e-5 on the same mesh; get_vtk_mesh drops the same components;
    method "tets" gives JAX's vertices (in the same order, within 1e-5 mm)
    and faces."""
    vol = np.maximum(_ball(), _ball(r=2.0, center=(3, 3, 3)))
    timg, jimg = _pair(vol, spacing=(0.5, 0.6, 0.7))
    got = TP.get_mesh_from_probability_map(timg)
    want = JP.get_mesh_from_probability_map(jimg)
    assert got.n_points == want.n_points > 500 and got.n_cells == want.n_cells
    np.testing.assert_allclose(np.sort(got.vertices, axis=0), np.sort(want.vertices, axis=0), atol=1e-5)
    np.testing.assert_allclose(TP.get_cell_centroid(got), JP.get_cell_centroid(got), atol=1e-5)
    np.testing.assert_allclose(TP.get_cell_normals(got), JP.get_cell_normals(got), atol=1e-5)
    kept_t = TP.get_vtk_mesh(got.vertices, got.faces, filter_threshold=1000)
    kept_j = JP.get_vtk_mesh(got.vertices, got.faces, filter_threshold=1000)
    assert kept_t.n_cells == kept_j.n_cells < got.n_cells
    np.testing.assert_array_equal(kept_t.faces, kept_j.faces)
    got = TP.get_mesh_from_probability_map(timg, method="tets")
    want = JP.get_mesh_from_probability_map(jimg, method="tets")
    assert got.n_points == want.n_points > 500
    np.testing.assert_allclose(got.vertices, want.vertices, atol=1e-5)
    np.testing.assert_array_equal(got.faces, want.faces)
    with pytest.raises(ValueError, match="unknown iso-surface method"):
        TP.get_mesh(timg, method="cubes")


def test_get_thickness_mesh_matches():
    """One tissue's (inner, outer) meshes: sizes within 0.5 %, mean
    thickness within 1e-3 mm (the whole-slice tolerances)."""
    timg, jimg = _pair(_shell_cap(), spacing=(0.5, 0.5, 0.7))
    got = TP.get_thickness_mesh(timg, mesh_type="FC", num_iterations=30)
    want = JP.get_thickness_mesh(jimg, mesh_type="FC", num_iterations=30)
    for g, w in zip(got, want):
        assert w.n_points > 300 and abs(g.n_points - w.n_points) <= 0.005 * w.n_points
        assert abs(float(np.mean(g.point_data)) - float(np.mean(w.point_data))) <= 1e-3


def _use(params):
    params[("batch_size", 4, "tiles per step")]
    sub = params.new_category("model", "network settings")
    sub[("name", "UNet", "registry name")]
    sub["BN"] = False
    params["lr"] = 1e-3
    nested = params[("optim", {"kind": "adam"}, "optimizer")]
    nested[("beta1", 0.9, "first moment")]
    return params


def test_parameter_dict_matches(tmp_path):
    """The same access sequence writes the same settings and comments JSON;
    loading reads them back."""
    for cls, name in ((TParams, "t"), (JParams, "j")):
        p = _use(cls({"epochs": 5}))
        p.write_JSON(tmp_path / f"{name}.json")
        p.write_JSON_comments(tmp_path / f"{name}_comments.json")
    for suffix in (".json", "_comments.json"):
        assert json.loads((tmp_path / f"t{suffix}").read_text()) == json.loads((tmp_path / f"j{suffix}").read_text())
    loaded = TParams().load_JSON(tmp_path / "t.json")
    assert loaded["epochs"] == 5 and loaded["model"]["name"] == "UNet" and "lr" in loaded
    with pytest.raises(KeyError, match="not set"):
        loaded["missing"]


def test_trace_writes_a_profile(tmp_path):
    with trace(None):
        pass
    assert not any(tmp_path.iterdir())
    with trace(str(tmp_path / "prof")):
        torch.ones(64).sum()
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1 and "traceEvents" in json.loads(files[0].read_text())


def test_segmenter_dice_matches(tmp_path):
    """Segmenter3DInPatchClassWise.test on two volumes (labels as a (C, D,
    H, W) array and as a pair): the same Dice as the JAX package's, within
    1e-6."""
    (tmp_path / "cfg.json").write_text(json.dumps({
        "patch_size": [32, 32, 16], "model": "UNet_light4",
        "model_setting": {"in_channels": 1, "n_classes": 2, "bias": True, "BN": False},
    }))
    save_checkpoint({"params": make_threshold_params(NETWORK_SPECS["UNet_light4"].replace(bias=True)), "epoch": 1},
                    False, tmp_path, name="seg.npz")
    config = {"ckpoint_path": str(tmp_path / "seg.npz"), "training_config_file": str(tmp_path / "cfg.json"),
              "batch_size": 2, "overlap_size": (4, 4, 2), "compute_dtype": "float32"}
    rng = np.random.default_rng(3)
    vols = [_ball(n=24, r=7.0) * 0.9 + rng.uniform(0, 0.1, (24, 24, 24)).astype(np.float32) for _ in range(2)]
    labels = [np.stack([_ball(n=24, r=7.5) > 0.5, _ball(n=24, r=6.0) > 0.5]).astype(np.float32),
              (_ball(n=24, r=6.5) > 0.5, np.zeros((24, 24, 24), np.float32))]
    got = TSeg("pred", dict(config, device="cpu")).test(
        [(timage(v, device="cpu"), lab) for v, lab in zip(vols, labels)])
    want = JSeg("pred", dict(config)).test([(jimage(v), lab) for v, lab in zip(vols, labels)])
    np.testing.assert_allclose(np.asarray(got["per_volume_dice"]), np.asarray(want["per_volume_dice"]), atol=1e-6)
    np.testing.assert_allclose(got["mean_dice"], want["mean_dice"], atol=1e-6)
    assert 0.5 < got["per_volume_dice"][0][0] <= 1.0


def _seg_config(tmp_path) -> dict:
    """A threshold-weights UNet_light4 (two of its convs perturbed, so every
    level carries signal) written by the port, read by both packages."""
    (tmp_path / "cfg.json").write_text(json.dumps({
        "patch_size": [32, 32, 16], "model": "UNet_light4",
        "model_setting": {"in_channels": 1, "n_classes": 2, "bias": True, "BN": False},
    }))
    params = make_threshold_params(NETWORK_SPECS["UNet_light4"].replace(bias=True))
    rng = np.random.default_rng(8)
    for name in ("enc0b", "dec0a"):
        params[name]["kernel"] = params[name]["kernel"] + rng.normal(0, 0.05, params[name]["kernel"].shape).astype(
            np.float32)
    save_checkpoint({"params": params, "epoch": 1}, False, tmp_path, name="seg.npz")
    return {"ckpoint_path": str(tmp_path / "seg.npz"), "training_config_file": str(tmp_path / "cfg.json"),
            "batch_size": 2, "overlap_size": (4, 4, 2), "compute_dtype": "float32"}


@pytest.mark.parametrize("threshold", [False, True])
def test_volume_fn_matches(tmp_path, threshold):
    """`volume_fn(shape, batch, threshold)` on a 13x40x36 volume: equal to
    `segment`'s maps (probabilities) or to them above 0.5 (threshold), and
    to JAX's `volume_fn` within the segmenter's f32 tolerance, 1e-4; with
    the threshold, a voxel may differ only where JAX's probability lies
    within 1e-4 of 0.5."""
    config = _seg_config(tmp_path)
    tseg, jseg = TSeg("pred", dict(config, device="cpu")), JSeg("pred", dict(config))
    tseg.pred_setup()
    jseg.pred_setup()
    vol = np.random.default_rng(9).uniform(0, 1, (13, 40, 36)).astype(np.float32)
    got = tseg.volume_fn(vol.shape, 2, threshold)(torch.from_numpy(vol)).numpy()
    assert got.shape == (2, 13, 40, 36)
    fc, tc = tseg.segment(timage(vol, device="cpu"))
    probs = torch.stack([fc.data, tc.data]).numpy()
    np.testing.assert_array_equal(got, (probs > 0.5).astype(np.float32) if threshold else probs)
    want = np.asarray(jseg.volume_fn(vol.shape, 2, threshold)(jseg.params, jnp.asarray(vol)))
    if not threshold:
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert want.max() > 0.5
    else:
        jprobs = np.asarray(jseg.volume_fn(vol.shape, 2, False)(jseg.params, jnp.asarray(vol)))
        differ = got != want
        assert np.all(np.abs(jprobs[differ] - 0.5) < 1e-4), int(differ.sum())
        assert 0 < want.mean() < 1


def test_distance_to_surface_async_matches():
    """`distance_to_surface_async` on the CPU: (distances, n) equal to
    `distance_to_surface`, within 1e-5 mm of JAX's (its array padded,
    sliced to n); no target cells or no points give (None, 0) in both."""
    mesh = TP.get_mesh_from_probability_map(timage(_ball(), device="cpu", spacing=(0.5, 0.6, 0.7)))
    pts = np.random.default_rng(10).uniform(0, 12, (301, 3)).astype(np.float32)
    d, n = TO.distance_to_surface_async(pts, mesh, device="cpu")
    assert n == 301 and isinstance(d, torch.Tensor) and d.shape == (301,)
    np.testing.assert_array_equal(d.numpy(), TO.distance_to_surface(pts, mesh, device="cpu"))
    jd, jn = JO.distance_to_surface_async(pts, mesh)
    assert jn == n
    np.testing.assert_allclose(d.numpy(), np.asarray(jd)[:jn], atol=1e-5)
    empty = type(mesh)(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    for args in ((pts, empty), (pts[:0], mesh)):
        assert TO.distance_to_surface_async(*args, device="cpu") == (None, 0) == JO.distance_to_surface_async(*args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TO.distance_to_surface_async(pts, mesh)


def test_make_threshold_params_takes_the_model():
    """The JAX call `make_threshold_params(model, ...)` with a `UNet3D`
    gives the same tree as the `UNetSpec` form, and JAX's (bit for bit)."""
    from oai_analysis_2_tpu.models.unet3d import NETWORK_SPECS as JSPECS
    from oai_analysis_2_tpu.models.unet3d import UNet3D as JUNet
    from oai_analysis_2_tpu.models.unet3d import make_threshold_params as jthreshold
    from oai_analysis_2_tpu_torch.utils.checkpoint import flatten_tree

    spec = NETWORK_SPECS["UNet_light4"].replace(bias=True)
    by_model = flatten_tree(make_threshold_params(UNet3D(spec, device="cpu"), gain=12.0, threshold=0.4))
    by_spec = flatten_tree(make_threshold_params(spec, 12.0, 0.4))
    jax_tree = flatten_tree(jthreshold(JUNet(JSPECS["UNet_light4"].replace(bias=True)), gain=12.0, threshold=0.4))
    assert set(by_model) == set(by_spec) == set(jax_tree)
    for k in by_model:
        np.testing.assert_array_equal(by_model[k], by_spec[k])
        np.testing.assert_array_equal(by_model[k], np.asarray(jax_tree[k]), err_msg=k)
    with pytest.raises(ValueError, match="bias"):
        make_threshold_params(UNet3D(NETWORK_SPECS["UNet_light4"].replace(bias=False), device="cpu"))


@pytest.mark.parametrize("mesh_type", ["FC", "TC"])
def test_project_thickness_takes_embedded(mesh_type):
    """`project_thickness(mesh, mesh_type, embedded=...)` (JAX's keyword,
    which neither body reads) returns what the call without it returns,
    and JAX's within 1e-4."""
    mesh = TP.get_mesh_from_probability_map(timage(_shell_cap(), device="cpu", spacing=(0.5, 0.5, 0.7)))
    mesh.vertices = mesh.vertices * np.float32(8.0)  # the TC plateaus split at z = 50
    mesh.point_data = np.linalg.norm(mesh.vertices, axis=1).astype(np.float32)
    plain = TPJ.project_thickness(mesh, mesh_type)
    got = TPJ.project_thickness(mesh, mesh_type, embedded=np.zeros((mesh.n_points, 2), np.float32))
    want = JPJ.project_thickness(mesh, mesh_type, embedded=None)
    for p, g, w in zip(plain, got, want):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4)


def test_stage_timer_takes_sync():
    """`StageTimer.stage(name, sync=tensors)`, JAX's form: the stage is
    timed and counted with a tensor, a tree of them or None."""
    timer = StageTimer()
    for sync in (torch.ones(3), [torch.ones(2), {"b": (torch.zeros(1),)}], None):
        with timer.stage("s", sync=sync):
            torch.ones(8).sum()
    with timer.stage("s"):
        pass
    assert timer.report()["s"]["calls"] == 4
