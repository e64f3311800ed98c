"""The PyTorch port's knee-batched pipeline (`parallel/batch.py`) against the
JAX package's, and its own contracts, on the CPU.

Both packages see the same seeded numpy knees (8x32x32 shells in noise, as
tests/test_batch_pipeline.py:54), the same UNet_light4 threshold weights
and the same random-init GradICON weights (grid (8, 16, 16), width 2),
carried across as numpy arrays. Tolerances are stated per test.
"""

import json
import time
import types
import warnings

import numpy as np
import pytest
import torch

import jax

from oai_analysis_2_tpu.core.image import image_from_array as jimage
from oai_analysis_2_tpu.engine.segmenter import Segmenter3DInPatchClassWise as JSeg
from oai_analysis_2_tpu.models.gradicon import GradICON as JGradICON
from oai_analysis_2_tpu.models.gradicon import GradICONConfig as JConfig
from oai_analysis_2_tpu.parallel.batch import BatchKneePipeline as JBatch
from oai_analysis_2_tpu_torch import bench
from oai_analysis_2_tpu_torch.core.image import image_from_array as timage
from oai_analysis_2_tpu_torch.engine.pipeline import KneePipeline as TPipeline
from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise as TSeg
from oai_analysis_2_tpu_torch.mesh.processing import get_thickness_meshes
from oai_analysis_2_tpu_torch.models.gradicon import GradICONConfig as TConfig
from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS, make_threshold_params
from oai_analysis_2_tpu_torch.parallel import BatchKneePipeline as TBatch
from oai_analysis_2_tpu_torch.parallel import CohortRunner
from oai_analysis_2_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(2)

REG = dict(grid_shape=(8, 16, 16), scales=(2, 1), stage_width=2)
SHAPE = (8, 32, 32)
SPACING = (0.5, 0.5, 1.0)


@pytest.fixture(scope="module")
def seg_config(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_batch")
    (tmp / "cfg.json").write_text(json.dumps({
        "patch_size": [32, 32, 8], "model": "UNet_light4",
        "model_setting": {"in_channels": 1, "n_classes": 2, "bias": True, "BN": False},
    }))
    params = make_threshold_params(NETWORK_SPECS["UNet_light4"].replace(bias=True))
    save_checkpoint({"params": params, "epoch": 1}, False, tmp, name="seg.npz")
    return {"ckpoint_path": str(tmp / "seg.npz"), "training_config_file": str(tmp / "cfg.json"),
            "batch_size": 4, "overlap_size": (8, 8, 2), "compute_dtype": "float32"}


def _knee(rng, shift, shape=SHAPE, radius=6.0):
    z, y, x = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")
    c = (shape[0] / 2, shape[1] / 2 + 1 - shift, shape[2] / 2)
    rr = np.sqrt(((z - c[0]) * 2.0) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
    shell = np.clip(1.0 - np.abs(rr - radius) / 2.0, 0, 1)
    return (shell * 0.8 + rng.uniform(0, 0.2, shape)).astype(np.float32)


@pytest.fixture(scope="module")
def volumes():
    rng = np.random.default_rng(3)
    knees = [_knee(rng, i) for i in range(3)]
    atlas = rng.uniform(0, 1, SHAPE).astype(np.float32)
    return knees, atlas


@pytest.fixture(scope="module")
def net_params():
    return JGradICON(JConfig(**REG)).init(jax.random.PRNGKey(0), zero_heads=False)


def _timgs(knees, spacing=SPACING):
    return [timage(k, spacing=spacing, device="cpu") for k in knees]


def _port(seg_config, atlas, net_params=None, spacing=SPACING, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = TBatch(TSeg("pred", dict(seg_config, device="cpu")), timage(atlas, spacing=spacing, device="cpu"),
                      registration_config=TConfig(**REG), device="cpu", **kw)
    if net_params is not None:
        pipe.registerer.load_params(jax.tree.map(np.asarray, net_params))
    return pipe


def _jax(seg_config, atlas, net_params=None, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = JBatch(JSeg("pred", dict(seg_config)), jimage(atlas, spacing=SPACING),
                      registration_config=JConfig(**REG), **kw)
    if net_params is not None:
        pipe.registerer.load_params(net_params)
    return pipe


@pytest.mark.parametrize("finetune_steps", [0, 2])
def test_network_mode_matches_jax(seg_config, volumes, net_params, finetune_steps):
    """Network mode, with and without fine-tuning (scale 2, lr 0.15): the
    warped maps within 1e-4 and the displacement fields within 1e-4 mm of
    JAX's (measured: 1e-5 and 2.3e-5)."""
    knees, atlas = volumes
    kw = dict(registration_mode="network", finetune_steps=finetune_steps)
    want_w, want_d = _jax(seg_config, atlas, net_params, **kw).run_device_batch(
        [jimage(k, spacing=SPACING) for k in knees[:2]])
    got_w, got_d = _port(seg_config, atlas, net_params, **kw).run_device_batch(_timgs(knees[:2]))
    assert got_w.shape == want_w.shape == (2,) + SHAPE + (2,) and want_w.max() > 0.5
    assert got_d.shape == want_d.shape == (2,) + REG["grid_shape"] + (3,)
    np.testing.assert_allclose(got_w, want_w, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_d, want_d, atol=1e-4, rtol=0)
    assert np.abs(want_d).mean() > 0.05  # the random network moves the maps


@pytest.mark.parametrize("steps", [1, 5])
def test_instance_mode_statistics_match_jax(seg_config, volumes, steps):
    """Instance mode at the default lr (1.2 voxels a step), scales (2, 1):
    chaotic at this size (tests/test_torch_instance.py; Adam's first step
    already flips elements whose gradient is rounding noise, moving them
    by millimetres), so held statistically per knee. After 1 step a
    scale: mean |displacement| and the warped maps' means within 2 % of
    JAX's. After 5: mean |displacement| within 10 %, as
    tests/test_torch_registration.py holds instance mode."""
    knees, atlas = volumes
    kw = dict(registration_mode="instance", instance_scales=(2, 1), instance_steps=(steps, steps))
    want_w, want_d = _jax(seg_config, atlas, **kw).run_device_batch([jimage(k, spacing=SPACING) for k in knees[:2]])
    got_w, got_d = _port(seg_config, atlas, **kw).run_device_batch(_timgs(knees[:2]))
    tol = 0.02 if steps == 1 else 0.1
    for i in range(2):
        jmag, tmag = float(np.abs(want_d[i]).mean()), float(np.abs(got_d[i]).mean())
        assert jmag > 0.5 and abs(tmag - jmag) <= tol * jmag, (i, tmag, jmag)
        for c in range(2 if steps == 1 else 0):
            jm, tm = float(want_w[i, ..., c].mean()), float(got_w[i, ..., c].mean())
            assert jm > 0.01 and abs(tm - jm) <= tol * jm, (i, c, tm, jm)
    assert np.isfinite(got_w).all() and np.isfinite(got_d).all()


def test_batch_equals_knees_alone_and_swaps(seg_config, volumes, net_params):
    """Two distinct knees batched equal each knee batched alone (the same
    tiling at this size), and the swapped pair gives swapped outputs, within
    1e-6."""
    knees, atlas = volumes
    pipe = _port(seg_config, atlas, net_params, registration_mode="network", finetune_steps=2)
    pair_w, pair_d = pipe.run_device_batch(_timgs(knees[:2]))
    swap_w, swap_d = pipe.run_device_batch(_timgs(knees[1::-1]))
    assert np.abs(pair_w[0] - pair_w[1]).max() > 0.1  # the knees differ
    for i in range(2):
        alone_w, alone_d = pipe.run_device_batch(_timgs(knees[i : i + 1]))
        np.testing.assert_allclose(pair_w[i], alone_w[0], atol=1e-6, rtol=0)
        np.testing.assert_allclose(pair_d[i], alone_d[0], atol=1e-6, rtol=0)
        np.testing.assert_allclose(swap_w[1 - i], pair_w[i], atol=1e-6, rtol=0)
        np.testing.assert_allclose(swap_d[1 - i], pair_d[i], atol=1e-6, rtol=0)


@pytest.mark.parametrize("data", ["knees", "phantom"])
def test_window_matches_jax_program(seg_config, volumes, net_params, data):
    """The port's batch window against the window stage of the JAX batch's
    own program, bit for bit: the three knees, and the full demo's 80x192x192
    phantom with a second knee. There the program's 99.9th percentile
    (position folded to 2,946,170.0) differs from `jnp.percentile` called
    alone (2,946,169.75), in both packages, by 1.5e-4 of the window."""
    from oai_analysis_2_tpu_torch.examples.full_demo import _phantom_knee
    from oai_analysis_2_tpu_torch.ops.intensity import percentile_window
    from oai_analysis_2_tpu_torch.parallel.batch import _window_knee

    knees, atlas = volumes
    if data == "phantom":
        x = _phantom_knee((80, 192, 192))
        knees = [x, x[::-1] * np.float32(0.5)]
    jpipe = _jax(seg_config, atlas, net_params, registration_mode="network")
    (window_j, _, _), _ = jpipe._batched_fn(jimage(knees[0], spacing=SPACING), len(knees))
    want = np.asarray(window_j(jax.numpy.asarray(np.stack(knees))))
    got = np.stack([_window_knee(torch.from_numpy(np.ascontiguousarray(k))).numpy() for k in knees])
    np.testing.assert_array_equal(got, want)
    if data == "phantom":
        alone = percentile_window(timage(knees[0], device="cpu")).data.numpy()
        assert np.abs(got[0] - alone).max() > 1e-4


def test_chunking_equals_unchunked(seg_config, volumes, net_params):
    """Five knees in chunks of two equal the same five in one pass (1e-6)."""
    knees, atlas = volumes
    five = _timgs([knees[0], knees[1], knees[2], knees[1], knees[0]])
    kw = dict(registration_mode="network", finetune_steps=0)
    chunked = _port(seg_config, atlas, net_params, max_batch_per_device=2, **kw).run_device_batch(five)
    whole = _port(seg_config, atlas, net_params, max_batch_per_device=5, **kw).run_device_batch(five)
    for got, want in zip(chunked, whole):
        assert got.shape[0] == 5
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def thick_runs(seg_config):
    """Knees large enough to keep meshes past the 3,000-cell component
    filter (12x40x40), registered by instance mode with no steps: the pair
    through run_batch, each knee alone, and run_batches over [k0], [], [k1]."""
    rng = np.random.default_rng(5)
    shape, spacing = (12, 40, 40), (0.5, 0.5, 0.5)
    knees = _timgs([_knee(rng, s, shape, radius=12.0) for s in (0, 2)], spacing)
    atlas = _knee(rng, 1, shape, radius=12.0)
    pipe = _port(seg_config, atlas, spacing=spacing, registration_mode="instance",
                 instance_scales=(2,), instance_steps=(0,))
    batches = [knees[:1], [], knees[1:]]
    return pipe.run_batch(knees), [pipe.run_batch(b) for b in batches], pipe.run_batches(batches)


def test_run_batch_thickness_equals_per_knee(thick_runs):
    """run_batch's one grouped thickness call equals get_thickness_meshes
    on each knee's own maps, exactly; the timings carry the substages."""
    results = thick_runs[0]
    assert len(results) == 2
    for r in results:
        want = get_thickness_meshes([r.fc_probmap, r.tc_probmap], ["FC", "TC"])
        for got_pair, want_pair in zip(((r.fc_inner, r.fc_outer), (r.tc_inner, r.tc_outer)), want):
            for got, w in zip(got_pair, want_pair):
                assert w.n_points > 100
                np.testing.assert_array_equal(got.vertices, w.vertices)
                np.testing.assert_array_equal(got.point_data, w.point_data)
        assert {"device_batch", "thickness_batch", "thickness_smooth", "thickness_distance",
                "thickness_mc"} <= set(r.timings)


def test_run_batches_equals_run_batch(thick_runs):
    """run_batches returns what run_batch returns per batch, in order,
    exactly, with the same stage timings; an empty batch gives an empty
    list. Each knee alone equals its place in the pair."""
    pair, want, got = thick_runs
    assert [len(g) for g in got] == [len(w) for w in want] == [1, 0, 1]
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(g.fc_probmap.data.numpy(), w.fc_probmap.data.numpy())
            for name in ("fc_inner", "fc_outer", "tc_inner", "tc_outer"):
                np.testing.assert_array_equal(getattr(g, name).point_data, getattr(w, name).point_data)
            assert set(g.timings) == set(w.timings) >= {"device_batch", "thickness_batch"}
    for p, alone in zip(pair, (want[0][0], want[2][0])):
        np.testing.assert_allclose(p.tc_probmap.data.numpy(), alone.tc_probmap.data.numpy(), atol=1e-6)


def test_contracts(seg_config, volumes):
    """A second geometry raises ValueError; the empty batch gives correctly
    ranked empties and run_batch([]) == []; network mode without weights
    raises; without device= the pipeline wants the card; a bad warp_dtype
    raises."""
    knees, atlas = volumes
    pipe = _port(seg_config, atlas, registration_mode="instance", instance_scales=(2,), instance_steps=(1,))
    other = timage(np.zeros(SHAPE, np.float32), spacing=(0.6, 0.5, 1.0), device="cpu")
    with pytest.raises(ValueError, match="geometr"):
        pipe.run_device_batch([_timgs(knees[:1])[0], other])
    warped, disp = pipe.run_device_batch([])
    assert warped.shape == (0,) + SHAPE + (2,) and disp.shape == (0,) + REG["grid_shape"] + (3,)
    assert pipe.run_batch([]) == []
    net = _port(seg_config, atlas, registration_mode="network", finetune_steps=0)
    assert net.registerer.params is None  # the shipped width-24 weights do not fit
    with pytest.raises(ValueError, match="without weights"):
        net.run_device_batch(_timgs(knees[:1]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TBatch(TSeg("pred", dict(seg_config, device="cpu")), timage(atlas, device="cpu"),
                   registration_mode="instance")
    with pytest.raises(ValueError, match="warp_dtype"):
        _port(seg_config, atlas, registration_mode="instance", warp_dtype="float16")


def test_cohort_runner_takes_the_batch_pipeline(seg_config, volumes, tmp_path):
    """CohortRunner(batch_pipeline=..., batch_size=2) over four knees: the
    batch pipeline runs twice, the single-item pipeline never, 4 done."""
    knees, atlas = volumes
    pipe = _port(seg_config, atlas, registration_mode="instance", instance_scales=(2,), instance_steps=(1,))
    calls = {"batch": 0, "single": 0}

    def run_batch(images):
        calls["batch"] += 1
        return [{"fc_points": r.fc_inner.n_points} for r in pipe.run_batch(images)]

    def single(image):
        calls["single"] += 1
        raise AssertionError("the single-item pipeline ran")

    runner = CohortRunner(single, tmp_path / "manifest.json", batch_pipeline=run_batch, batch_size=2,
                          claim_settle=0.0, verbose=False)
    items = _timgs([knees[0], knees[1], knees[0], knees[1]])
    summary = runner.run(items, keys=[f"knee{i}" for i in range(4)])
    assert summary == {"done": 4}
    assert calls == {"batch": 2, "single": 0}


BATCH_KEYS = ("batch2_seconds_per_knee", "batch_efficiency_vs_single", "batch8_seconds_total",
              "batch8_device_seconds", "batch8_thickness_seconds", "batch8_thickness_smooth_seconds",
              "batch8_thickness_distance_seconds", "batch8_thickness_mc_seconds", "batch4_seconds_total",
              "batch4_pipelined_seconds_per_batch", "batch_overlap_gain", "segment_seconds_reference_tiling",
              "seconds_per_knee_reference_tiling")


def _bench_pipe(seg_config, atlas):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return TPipeline(TSeg("pred", dict(seg_config, device="cpu")), timage(atlas, spacing=SPACING, device="cpu"),
                         registration_config=TConfig(**REG), registration_mode="instance",
                         instance_scales=(2,), instance_steps=(1,), device="cpu")


def test_bench_batched_phases_keys(seg_config, volumes, monkeypatch):
    """The bench's batched phases give every key, finite and positive, no
    TPU projection, and peak memory keys (None off the card). run_batch is
    a stub with fixed stage timings (test_run_batch_thickness_equals_per_knee
    holds the real ones); the phases call it with B = 2 (warm-up and two
    timed), 8 (twice) and 4 (once, then three batches through run_batches)."""
    knees, atlas = volumes
    pipe = _bench_pipe(seg_config, atlas)
    knee = _timgs(knees[:1])[0]
    stages = ("device_batch", "thickness_batch", "thickness_smooth", "thickness_distance", "thickness_mc")
    fixed = types.SimpleNamespace(timings={k: {"seconds": 0.5, "calls": 1} for k in stages})
    sizes = []

    def stub(self, images, compute_thickness=True):
        sizes.append(len(images))
        time.sleep(0.01)
        return [fixed] * len(images)

    monkeypatch.setattr(TBatch, "run_batch", stub)
    out = bench.batched_phases(pipe, knee, dt=1.0, segment_seconds=0.1)
    assert sizes == [2, 2, 2, 8, 8, 4, 4, 4, 4]
    for key in BATCH_KEYS:
        assert np.isfinite(out[key]) and out[key] > 0, key
    assert out["batch8_device_seconds"] == out["batch8_thickness_mc_seconds"] == 0.5
    for phase in ("batch2", "batch8", "batch4", "reference_tiling"):
        assert f"{phase}_peak_memory_gb" in out and out[f"{phase}_peak_memory_gb"] is None
    assert not any("v5e" in k or "projected" in k for k in out)


def test_bench_fails_when_a_batched_phase_fails(seg_config, volumes, monkeypatch, capsys):
    """A run_batch that raises fails `bench` (no retry, no recorded error
    that lets the command succeed); the printed line carries the error."""
    knees, atlas = volumes
    knee = _timgs(knees[:1])[0]
    pipe = _bench_pipe(seg_config, atlas)
    big = types.SimpleNamespace(n_points=2000, point_data=np.full(2000, 1.5, np.float32))
    fake_result = types.SimpleNamespace(fc_inner=big, tc_inner=big, registration_quality=None,
                                        timings={"segment": {"seconds": 0.1, "calls": 1}})
    monkeypatch.setattr(pipe, "run", lambda image: fake_result)
    monkeypatch.setattr(bench, "card_line", lambda: "test card, 0 W")
    monkeypatch.setattr(bench, "_measure_fresh_warmup", lambda: 1.0)
    monkeypatch.setattr(bench, "build_pipeline", lambda device=None: (pipe, knee))

    def broken(self, images, compute_thickness=True):
        raise RuntimeError("batch broke")

    monkeypatch.setattr(TBatch, "run_batch", broken)
    with pytest.raises(RuntimeError, match="batch broke"):
        bench.main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "batch broke" in line["error"] and "batch2_seconds_per_knee" not in line
