"""The PyTorch port's image, intensity, warp, tiling and segmenter modules
against the JAX package, on the same numpy inputs, on the CPU."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oai_analysis_2_tpu.core import image as JI
from oai_analysis_2_tpu.engine.segmenter import Segmenter3DInPatchClassWise as JSeg
from oai_analysis_2_tpu.ops import intensity as JN
from oai_analysis_2_tpu.ops import resample as JRS
from oai_analysis_2_tpu.ops.tiling import Partition as JPartition
from oai_analysis_2_tpu.utils.checkpoint import load_checkpoint as jload
from oai_analysis_2_tpu_torch.core import image as TI
from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise as TSeg
from oai_analysis_2_tpu_torch.examples.full_demo import _phantom_knee
from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS, make_threshold_params
from oai_analysis_2_tpu_torch.ops import intensity as TN
from oai_analysis_2_tpu_torch.ops import resample as TRS
from oai_analysis_2_tpu_torch.ops.tiling import Partition as TPartition
from oai_analysis_2_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(2)

DIRECTION = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)


def _images(data, **meta):
    return JI.image_from_array(data, **meta), TI.image_from_array(data, device="cpu", **meta)


def test_physical_maps_match():
    rng = np.random.default_rng(0)
    meta = dict(origin=(1.5, -2.0, 3.25), spacing=(0.36, 0.4, 0.7), direction=DIRECTION)
    jimg, timg = _images(rng.uniform(0, 1, (5, 6, 7)).astype(np.float32), **meta)
    grid_j = np.asarray(JI.physical_grid((5, 6, 7), jimg.origin, jimg.spacing, jimg.direction))
    grid_t = TI.physical_grid((5, 6, 7), timg.origin, timg.spacing, timg.direction).numpy()
    np.testing.assert_array_equal(grid_t, grid_j)
    pts = rng.uniform(-10, 10, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(timg.physical_to_indices(torch.tensor(pts)).numpy(),
                               np.asarray(jimg.physical_to_indices(jnp.asarray(pts))), atol=1e-5)


@pytest.mark.parametrize("percs", [(0.1, 99.9), (0.0, 100.0), (37.5, 62.5)])
def test_percentile_window_matches(percs):
    """lo, hi and the window bit for bit: the port forms the interpolation
    position and weights in float32 as XLA's `jnp.percentile` does."""
    data = np.random.default_rng(1).gamma(2.0, 100.0, (9, 31, 17)).astype(np.float32)
    jimg, timg = _images(data)
    want = np.asarray(JN.percentile_window(jimg, *percs, 0.0, 1.0).data)
    got = TN.percentile_window(timg, *percs, 0.0, 1.0).data.numpy()
    np.testing.assert_array_equal(got, want)
    # the order statistics themselves are jnp.percentile's
    lo, hi = TN._percentiles(torch.tensor(data), percs)
    np.testing.assert_array_equal(np.float32([lo, hi]), [np.float32(jnp.percentile(jnp.asarray(data), p))
                                                          for p in percs])


@pytest.fixture(scope="module")
def phantom_knee():
    """The full demo's phantom knee at 80x192x192, before its window."""
    return _phantom_knee((80, 192, 192))


def test_percentile_window_matches_at_a_knee_size(phantom_knee):
    """At the phantom's 2,949,120 voxels the float32 position of the 99.9th
    percentile rounds: XLA's `p * ((n - 1) * 0.01)` gives 2,946,169.75,
    `(p / 100) * (n - 1)` 2,946,170.0, and hi moves from 552.21167 to
    552.29260 (the window by 1.5e-4). lo, hi and the window bit for bit."""
    jimg, timg = _images(phantom_knee, spacing=(0.36, 0.36, 0.7))
    want = [np.float32(jnp.percentile(jnp.asarray(phantom_knee), p)) for p in (0.1, 99.9)]
    assert want[1] == np.float32(552.21167)
    np.testing.assert_array_equal(np.float32(TN._percentiles(torch.tensor(phantom_knee), (0.1, 99.9))), want)
    np.testing.assert_array_equal(TN.percentile_window(timg).data.numpy(),
                                  np.asarray(JN.percentile_window(jimg).data))


def _field(shape, rng, scale=1.5):
    return rng.normal(0, scale, shape + (3,)).astype(np.float32)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resample_images_match(aligned, dtype):
    """The axis-aligned case takes the separable field upsample, the rotated
    one the general gather; bf16 gathers the sources in bf16."""
    rng = np.random.default_rng(2)
    moving = [rng.uniform(0, 1, (10, 12, 14)).astype(np.float32) for _ in range(2)]
    ref_meta = dict(origin=(0.5, 0.0, -0.5), spacing=(0.9, 1.1, 1.2))
    ref_j, ref_t = _images(np.zeros((8, 11, 9), np.float32), **ref_meta)
    fmeta = dict(origin=(0.0, 0.25, 0.0), spacing=(3.0, 2.5, 3.5))
    if not aligned:
        fmeta["direction"] = DIRECTION
    field = _field((4, 5, 4), rng)
    fj, ft = _images(np.zeros((4, 5, 4), np.float32), **fmeta)
    disp_j = JRS.DisplacementField(jnp.asarray(field), fj.origin, fj.spacing, fj.direction)
    disp_t = TRS.DisplacementField(torch.tensor(field), ft.origin, ft.spacing, ft.direction)
    assert (JRS._separable_resize_weights(disp_j, ref_j) is not None) == aligned
    assert (TRS._separable_resize_weights(disp_t, ref_t) is not None) == aligned
    mj = [_images(m, spacing=(1.0, 1.0, 1.0))[0] for m in moving]
    mt = [_images(m, spacing=(1.0, 1.0, 1.0))[1] for m in moving]
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    want = JRS.resample_images(mj, ref_j, displacement=disp_j, compute_dtype=jdt)
    got = TRS.resample_images(mt, ref_t, displacement=disp_t, compute_dtype=tdt)
    for w, g in zip(want, got):
        assert g.data.dtype == torch.float32
        np.testing.assert_allclose(g.data.numpy(), np.asarray(w.data), atol=1e-5)
    # the single-image form and the no-displacement form
    w1 = JRS.resample_image(mj[0], ref_j)
    g1 = TRS.resample_image(mt[0], ref_t)
    np.testing.assert_allclose(g1.data.numpy(), np.asarray(w1.data), atol=1e-5)


def test_partition_geometry_matches():
    for tile, ov, shape in [((32, 32, 16), (4, 4, 2), (24, 48, 40)), ((416, 416, 48), (16, 16, 8), (160, 384, 384))]:
        jp, tp = JPartition(tile, ov), TPartition(tile, ov)
        assert tp.tile_size == jp.tile_size and tp.overlap_size == jp.overlap_size
        assert tp.effective_size == jp.effective_size
        assert tp.grid_shape(shape) == jp.grid_shape(shape)
        assert tp.num_tiles(shape) == jp.num_tiles(shape)
    with pytest.raises(ValueError):
        TPartition((8, 8, 8), (4, 4, 4))


@pytest.fixture(scope="module")
def seg_files(tmp_path_factory):
    """A threshold-weights UNet_light4 checkpoint, written by the port and
    read by both packages, so the probability maps are comparable."""
    tmp = tmp_path_factory.mktemp("torch_seg")
    (tmp / "cfg.json").write_text(json.dumps({
        "patch_size": [32, 32, 16], "model": "UNet_light4",
        "model_setting": {"in_channel": 1, "n_classes": 2, "bias": True, "BN": False},
    }))
    params = make_threshold_params(NETWORK_SPECS["UNet_light4"].replace(bias=True))
    rng = np.random.default_rng(5)
    for name in ("enc0b", "enc1a", "dec0a"):  # perturb so every conv carries signal
        params[name]["kernel"] = params[name]["kernel"] + rng.normal(0, 0.05, params[name]["kernel"].shape).astype(np.float32)
    save_checkpoint({"params": params, "epoch": 3, "best_score": 0.5}, False, tmp, name="seg.npz")
    return tmp


def test_checkpoint_round_trip(seg_files):
    ours, theirs = load_checkpoint(seg_files / "seg.npz"), jload(seg_files / "seg.npz")
    assert ours["epoch"] == theirs["epoch"] == 3
    np.testing.assert_array_equal(ours["params"]["dec0a"]["kernel"], np.asarray(theirs["params"]["dec0a"]["kernel"]))


@pytest.mark.parametrize("name", ["UNet", "UNet_light4"])
def test_threshold_unet_logits_match_bf16(name):
    """The threshold-weights UNet in bf16 (the phantom demo's segmenter)
    gives JAX's logits bit for bit: XLA keeps the bf16 head's f32
    accumulator through `astype(float32)`, so the port's 1x1x1 head and
    upconv take f32 products of the bf16 operands and do not round to bf16
    before the bias (which moved logits by up to 0.0625)."""
    from oai_analysis_2_tpu.models import unet3d as JU
    from oai_analysis_2_tpu_torch.models import unet3d as TU
    from oai_analysis_2_tpu_torch.utils.checkpoint import carry_params

    jm = JU.UNet3D(JU.NETWORK_SPECS[name].replace(bias=True), compute_dtype=jnp.bfloat16)
    params = JU.make_threshold_params(jm)
    x = np.random.default_rng(0).uniform(0, 1, (1, 8, 32, 32, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tm = TU.UNet3D(TU.NETWORK_SPECS[name].replace(bias=True), compute_dtype=torch.bfloat16, device="cpu")
    carry_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,atol,ips", [("float32", 1e-4, None), ("bfloat16", 2e-2, None),
                                             ("float32", 1e-4, "train")])
def test_segmenter_matches(seg_files, dtype, atol, ips):
    config = {"ckpoint_path": str(seg_files / "seg.npz"), "training_config_file": str(seg_files / "cfg.json"),
              "batch_size": 2, "overlap_size": (4, 4, 2), "compute_dtype": dtype}
    if ips:
        config["inference_patch_size"] = ips
    jseg, tseg = JSeg("pred", dict(config)), TSeg("pred", dict(config, device="cpu"))
    data = np.random.default_rng(6).uniform(0, 1, (13, 40, 36)).astype(np.float32)
    jimg, timg = _images(data, spacing=(0.36, 0.36, 0.7))
    jfc, jtc = jseg.segment(jimg)
    tfc, ttc = tseg.segment(timg)
    part_j = jseg.partition_for(data.shape)
    part_t = tseg.partition_for(data.shape)
    assert part_t.tile_size == part_j.tile_size
    assert (part_t.tile_size[1] > 32) == (ips is None)  # auto z-slabs span y, x
    for w, g in ((jfc, tfc), (jtc, ttc)):
        np.testing.assert_allclose(g.data.numpy(), np.asarray(w.data), atol=atol)
    assert np.asarray(jfc.data).max() > 0.5
