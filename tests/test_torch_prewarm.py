"""The port's `prewarm` (`oai_analysis_2_tpu_torch/engine/prewarm.py`), its
CLI and the dispatch of the CLI's `prewarm`, `bench` and `cohort`
commands, against the JAX package's (`tests/test_prewarm.py`).

The report is held to the JAX package's keys. The phantom knee runs on the
CPU at 16x32x32 with a small segmenter and one instance step a scale, to
keep it to seconds; the production configuration runs on the card
(`chip_smoke.py` phase 9).
"""

import json
import types
import warnings

import numpy as np
import pytest
import torch

import bench as repo_bench
from oai_analysis_2_tpu.engine import prewarm as JPrewarm
from oai_analysis_2_tpu_torch import __main__ as TMain
from oai_analysis_2_tpu_torch import native
from oai_analysis_2_tpu_torch import bench as TBench
from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject
from oai_analysis_2_tpu_torch.engine import prewarm as TPrewarm
from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS, make_threshold_params
from oai_analysis_2_tpu_torch.ops import cuda_build
from oai_analysis_2_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(2)


@pytest.mark.parametrize("argv,error", [
    (["--shape", "48,96"], SystemExit),  # wants D,H,W
    (["--shape", "a,b,c"], ValueError),
    (["--registration-mode", "bogus"], SystemExit),
    (["--bogus-flag"], SystemExit),
])
def test_prewarm_cli_refusals_match_jax(argv, error):
    for main in (TPrewarm.main, JPrewarm.main):
        with pytest.raises(error):
            main(argv)


def test_prewarm_cli_device_flag(monkeypatch):
    seen = {}
    monkeypatch.setattr(TPrewarm, "prewarm", lambda **kw: seen.update(kw) or {"ok": True})
    assert TPrewarm.main(["--shape", "8,16,16", "--device", "cpu", "--finetune-steps", "3",
                          "--registration-mode", "instance"]) == {"ok": True}
    assert seen == {"shape_zyx": (8, 16, 16), "registration_mode": "instance", "finetune_steps": 3, "device": "cpu"}
    TPrewarm.main([])
    assert seen == {"shape_zyx": (160, 384, 384), "registration_mode": "auto", "finetune_steps": 20, "device": "cuda"}


def test_module_dispatch(monkeypatch):
    """`prewarm` goes to its own parser with the remaining argv (before the
    main parser sees it), `bench` to the port's bench module."""
    seen = {}
    monkeypatch.setattr(TPrewarm, "main", lambda argv: seen.setdefault("prewarm", argv))
    monkeypatch.setattr(TBench, "main", lambda: seen.setdefault("bench", True))
    TMain.main(["prewarm", "--shape", "8,16,16", "--device", "cpu"])
    TMain.main(["bench"])
    assert seen == {"prewarm": ["--shape", "8,16,16", "--device", "cpu"], "bench": True}
    with pytest.raises(SystemExit):
        TMain.main(["bench", "--extra"])


def _jax_report_keys(monkeypatch) -> set:
    """The keys of the JAX package's prewarm report, with its pipeline
    stubbed out (its knee would compile the production graph)."""
    from oai_analysis_2_tpu.core.image import image_from_array
    from oai_analysis_2_tpu.engine import pipeline as JPipe

    class Stub:
        def __init__(self, *args, **kwargs):
            self.registerer = types.SimpleNamespace(mode="network")

        def run(self, knee):
            return types.SimpleNamespace(timings={"segment": {"seconds": 0.0, "calls": 1}})

    monkeypatch.setattr(JPipe, "KneePipeline", Stub)
    atlas = image_from_array(np.zeros((16, 32, 32), np.float32))
    return set(JPrewarm.prewarm(analysis_object=types.SimpleNamespace(segmenter=None, atlas_image=atlas),
                                shape_zyx=(16, 32, 32)))


def test_prewarm_report_on_the_cpu(tmp_path, monkeypatch):
    """prewarm(device="cpu", shape_zyx=(16, 32, 32)) through the whole
    pipeline: the JAX report's keys, every stage timed, the kernel-library
    count between 0 and the number of sources."""
    models = tmp_path / "models"
    models.mkdir()
    save_checkpoint({"params": make_threshold_params(NETWORK_SPECS["UNet_light4"].replace(bias=True)), "epoch": 1},
                    False, models, name="segmentation_model.npz")
    (models / "segmentation_train_config.pth.tar").write_text(json.dumps({
        "patch_size": [32, 32, 16], "model": "UNet_light4",
        "model_setting": {"in_channels": 1, "n_classes": 2, "bias": True, "BN": False}}))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        obj = AnalysisObject(models_path=models, atlas_path="phantom:16,32,32", compute_dtype="float32",
                             overlap_size=(4, 4, 2), device="cpu")
        report = TPrewarm.prewarm(obj, shape_zyx=(16, 32, 32), registration_mode="instance",
                                  instance_steps=(1, 1, 1), device="cpu")
    assert set(report) == _jax_report_keys(monkeypatch)
    assert report["shape_zyx"] == [16, 32, 32] and report["registration_mode"] == "instance"
    assert set(report["stage_seconds"]) == {"preprocess", "segment", "register", "warp", "thickness"}
    assert report["first_knee_seconds"] > 0 and report["prewarm_seconds"] >= report["first_knee_seconds"]
    n = len(cuda_build.EXTRA_FLAGS) + 1  # the kernel libraries and the host-geometry library
    assert 0 <= report["compile_cache_entries_before"] <= report["compile_cache_entries_after"] <= n
    assert native.library_path().exists()  # built up front
    json.dumps(report)


def test_prewarm_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TPrewarm.prewarm(shape_zyx=(16, 32, 32))


def test_built_library_count(tmp_path, monkeypatch):
    """The count is of libraries built from the current sources and flags:
    kernel libraries and the host-geometry library."""
    monkeypatch.setattr(cuda_build, "_BUILD", tmp_path)
    monkeypatch.setattr(native, "_BUILD", tmp_path / "native")
    assert TPrewarm._built_libraries() == 0
    for name in ("conv3d_sm90", "point_triangle"):
        cuda_build.library_path(name).write_bytes(b"")
    (tmp_path / "conv3d_f32-0000000000000000.so").write_bytes(b"")  # a stale build
    assert TPrewarm._built_libraries() == 2
    (tmp_path / "native").mkdir()
    (tmp_path / "native" / "libnative-0000000000000000.so").write_bytes(b"")  # a stale build
    assert TPrewarm._built_libraries() == 2
    native.library_path().write_bytes(b"")
    assert TPrewarm._built_libraries() == 3


def test_bench_fixture_is_the_repo_bench_fixture():
    """The port's bench fixture is `bench.py`'s shell, at a small grid."""
    shape = (24, 48, 40)
    for kw in ({}, dict(r_inner=8.0, r_outer=11.0, center=(12, 26, 20))):
        np.testing.assert_array_equal(TBench.shell_probmap(shape, **kw), repo_bench._shell_probmap(shape, **kw))
    assert TBench.BASELINE_KNEES_PER_HOUR == repo_bench.BASELINE_KNEES_PER_HOUR
    knee, atlas = TBench.knee_and_atlas((16, 32, 32), (5.0, 7.0, None), (3.0, 4.0, (8, 19, 16)),
                                        (5.0, 7.0, (8, 17, 15)), (3.0, 4.0, (8, 18, 15)))
    assert knee.shape == atlas.shape == (16, 32, 32) and knee.dtype == atlas.dtype == np.float32
    assert knee.max() > 900 and 0.0 <= atlas.min() and atlas.max() <= 1.0
    assert TBench.FULL["shape"] == (160, 384, 384)


def test_bench_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TBench.build_pipeline()
    assert TBench.host_cpu()["count"] >= 1


@pytest.mark.parametrize("rc,stdout,ok", [
    (0, 'noise\n{"warmup_seconds": 12.5}\n', True),
    (0, "no result\n", False),
    (1, '{"warmup_seconds": 12.5}\n', False),
    (0, '{"warmup_seconds": NaN}\n', False),
    (0, '{"warmup_seconds": 0.0}\n', False),
])
def test_bench_fresh_probe_result_or_raise(monkeypatch, rc, stdout, ok):
    """The fresh-process probe's seconds are a positive number, or bench
    fails: a probe that crashed or printed nothing never reads as null."""
    import subprocess

    monkeypatch.setattr(TBench.subprocess, "run",
                        lambda cmd, **kw: subprocess.CompletedProcess(cmd, rc, stdout, "probe stderr"))
    if ok:
        assert TBench._measure_fresh_warmup() == 12.5
    else:
        with pytest.raises(RuntimeError, match="probe"):
            TBench._measure_fresh_warmup()


def test_prewarm_refuses_thickness_off():
    """`thickness=False` is refused, not ignored: the knee always runs its
    thickness stage."""
    with pytest.raises(ValueError, match="thickness"):
        TPrewarm.prewarm(thickness=False, device="cpu")
