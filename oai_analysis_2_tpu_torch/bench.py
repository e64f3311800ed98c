"""Pipeline benchmark on the card (port of the headline, batched and
reference-tiling phases of the repo-root `bench.py:87-578`, which imports
JAX).

    python -m oai_analysis_2_tpu_torch bench

The fixture is `bench.py`'s (`:70-183`): a 160x384x384 DESS-like knee
carrying two cartilage-like shells and a shell atlas, the full production
`UNet` with threshold weights (bf16, batch 8, overlap (16, 16, 8)) so the
segmenter's own maps carry the shells, registration "auto" with 20
fine-tuning steps, bf16 warp. A subprocess of this module first measures
what a fresh process pays before its first knee (kernel libraries loaded
or built, the CUDA context, the allocator); then this process runs one
warm-up knee and three timed knees and reports the median with that
sample's stage seconds.

Knobs (defaults = the production configuration): BENCH_REG_MODE,
BENCH_INST_STEPS ("80,60,40"), BENCH_FT_STEPS, BENCH_SEG_BATCH.

Prints ONE JSON line: `bench.py`'s headline keys ("metric", "value" in
knees/hour/card, "unit", "vs_baseline", "seconds_per_knee",
"knee_samples", "warmup_seconds", "warmup_seconds_fresh_process",
"stage_seconds", mesh sizes and the FC median thickness) plus the card's
name and power limit, the host CPU and `peak_memory_gb`, then the batched
keys (`batch2_seconds_per_knee`, `batch_efficiency_vs_single`,
`batch8_seconds_total`, `batch8_device_seconds`,
`batch8_thickness_seconds` and its `_smooth`, `_distance` and `_mc`
seconds, `batch4_seconds_total`, `batch4_pipelined_seconds_per_batch`,
`batch_overlap_gain`, `segment_seconds_reference_tiling`,
`seconds_per_knee_reference_tiling`, and `<phase>_peak_memory_gb`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from oai_analysis_2_tpu_torch import native

BASELINE_KNEES_PER_HOUR = 3600.0 / 148.0  # the reference's Colab GPU pipeline
SPACING = (0.36, 0.36, 0.7)  # x, y, z mm


def shell_probmap(shape_zyx, r_inner=47.5, r_outer=52.5, center=None):
    """A curved cartilage-like shell (probability ~1 between two radii,
    limited to a polar cap) on the atlas grid (`bench.py:70-84`)."""
    d, h, w = shape_zyx
    c = center or (d * 0.5, h * 0.55, w * 0.5)
    z, y, x = np.meshgrid(
        np.arange(d, dtype=np.float32),
        np.arange(h, dtype=np.float32),
        np.arange(w, dtype=np.float32),
        indexing="ij",
    )
    rr = np.sqrt(((z - c[0]) * 2.4) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
    shell = np.clip(1.0 - np.abs(rr - (r_inner + r_outer) / 2) / ((r_outer - r_inner) / 2), 0, 1)
    cap = (y < c[1]).astype(np.float32)  # upper cap only
    return (shell * cap).astype(np.float32)


def knee_and_atlas(shape, fc, tc, atlas_fc, atlas_tc, seed=0):
    """The bench fixture (`bench.py:128-153`): a DESS-like knee carrying two
    shells, and an atlas with the same anatomy slightly shifted and matched
    background texture. fc/tc/atlas_*: (r_inner, r_outer, center or None)."""
    rng = np.random.default_rng(seed)
    anatomy = np.maximum(shell_probmap(shape, *fc), shell_probmap(shape, *tc))
    knee = (anatomy * 900.0 + rng.uniform(0.0, 250.0, shape)).astype(np.float32)
    atlas_anatomy = np.maximum(shell_probmap(shape, *atlas_fc), shell_probmap(shape, *atlas_tc))
    atlas = (atlas_anatomy * 0.78 + rng.uniform(0.0, 0.22, shape)).astype(np.float32)
    return knee, atlas


# the production grid; shell radii sized so the meshes match the reference's
# real-knee mesh budget (bench.py:128-139)
FULL = dict(shape=(160, 384, 384), fc=(47.5, 52.5, None), tc=(31.5, 35.5, (80, 230, 192)),
            atlas_fc=(47.5, 52.5, (80, 206, 184)), atlas_tc=(31.5, 35.5, (80, 222, 184)))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def host_cpu() -> dict:
    """The host CPU's model name and logical core count: the host-bound
    stages move with it."""
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return {"model": model, "count": os.cpu_count()}


def _reset_peak(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(device)


def _peak_gb(device):
    """Peak device memory since the last reset, in GB; None off the card."""
    if device.type != "cuda":
        return None
    import torch

    return round(torch.cuda.max_memory_allocated(device) / 1e9, 3)


def _timed(device, fn):
    """(seconds, result) of `fn()`, the device synchronized at the end."""
    from oai_analysis_2_tpu_torch.core.device import synchronize

    t0 = time.perf_counter()
    result = fn()
    synchronize(device)
    return time.perf_counter() - t0, result


def batched_phases(pipe, knee, dt: float, segment_seconds: float) -> dict:
    """The knee-batched and reference-tiling phases (`bench.py:325-484,
    :523-578`) on copies of `knee` with `pipe`'s segmenter, atlas and
    registration; `dt` and `segment_seconds` are the single knee's seconds
    and its segment stage's. Raises when a phase fails."""
    from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise
    from oai_analysis_2_tpu_torch.ops.intensity import percentile_window
    from oai_analysis_2_tpu_torch.parallel.batch import BatchKneePipeline

    dev = pipe.device
    reg = pipe.registerer
    bpipe = BatchKneePipeline(pipe.segmenter, pipe.atlas, registration_config=pipe.reg_config,
                              registration_mode=reg.mode, instance_scales=reg.instance_scales,
                              instance_steps=reg.instance_steps, finetune_steps=reg.finetune_steps,
                              finetune_scales=reg.finetune_scales, finetune_lr=reg.finetune_lr,
                              normalize=pipe.normalize, warp_dtype=pipe.warp_dtype, device=dev)
    out = {}

    # B = 2: the batched segmenter's tiling (two knees exceed the slab budget)
    pair = [knee, knee]
    _reset_peak(dev)
    bpipe.run_batch(pair)  # warm-up
    per_knee = min(_timed(dev, lambda: bpipe.run_batch(pair))[0] for _ in range(2)) / 2.0
    out.update(batch2_seconds_per_knee=round(per_knee, 4), batch_efficiency_vs_single=round(dt / per_knee, 4),
               batch2_peak_memory_gb=_peak_gb(dev))

    # B = 8 in four passes of two knees; thickness of all 16 tissues in one call
    b8 = [knee] * 8
    _reset_peak(dev)
    total, r8 = min((_timed(dev, lambda: bpipe.run_batch(b8)) for _ in range(2)), key=lambda s: s[0])
    t8 = {k: v["seconds"] for k, v in r8[0].timings.items()}
    del r8
    out.update(batch8_seconds_total=round(total, 4), batch8_device_seconds=t8["device_batch"],
               batch8_thickness_seconds=t8["thickness_batch"],
               batch8_thickness_smooth_seconds=t8["thickness_smooth"],
               batch8_thickness_distance_seconds=t8["thickness_distance"],
               batch8_thickness_mc_seconds=t8["thickness_mc"], batch8_peak_memory_gb=_peak_gb(dev))

    # B = 4: one batch, then three through run_batches (one stream: the
    # batches run in turn, so the gain reads 1 up to noise)
    b4 = [knee] * 4
    _reset_peak(dev)
    b4_total = _timed(dev, lambda: bpipe.run_batch(b4))[0]
    b4_pipelined = _timed(dev, lambda: bpipe.run_batches([b4, b4, b4]))[0] / 3.0
    out.update(batch4_seconds_total=round(b4_total, 4), batch4_pipelined_seconds_per_batch=round(b4_pipelined, 4),
               batch_overlap_gain=round(b4_total / b4_pipelined, 4), batch4_peak_memory_gb=_peak_gb(dev))
    del bpipe

    # the reference's training-patch tiling of the segment stage
    seg_dial = Segmenter3DInPatchClassWise(mode="pred", config={**pipe.segmenter.config, "batch_size": 8,
                                                               "inference_patch_size": "train"})
    seg_dial.pred_setup()
    pre = percentile_window(knee, 0.1, 99.9, 0.0, 1.0) if pipe.normalize else knee
    _reset_peak(dev)
    seg_dial.segment(pre)  # warm-up
    dial = sorted(_timed(dev, lambda: seg_dial.segment(pre))[0] for _ in range(3))[1]
    out.update(segment_seconds_reference_tiling=round(dial, 4),
               seconds_per_knee_reference_tiling=round(dt - segment_seconds + dial, 4),
               reference_tiling_peak_memory_gb=_peak_gb(dev))
    return out


def build_pipeline(device=None):
    """The bench pipeline and knee on `device` (None: the card)."""
    from oai_analysis_2_tpu_torch.analysis_object import _phantom_models_dir
    from oai_analysis_2_tpu_torch.core.device import resolve_device
    from oai_analysis_2_tpu_torch.core.image import image_from_array
    from oai_analysis_2_tpu_torch.engine.pipeline import KneePipeline
    from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise

    device = resolve_device(device)
    # the production UNet computing sigmoid(24 (x - 0.5)): the knee's shells
    # come out of the segmenter as clean probability maps
    models = _phantom_models_dir()
    segmenter = Segmenter3DInPatchClassWise(mode="pred", config={
        "ckpoint_path": str(models / "segmentation_model.npz"),
        "training_config_file": str(models / "segmentation_train_config.pth.tar"),
        "batch_size": int(os.environ.get("BENCH_SEG_BATCH", "8")),
        "overlap_size": (16, 16, 8),
        "compute_dtype": "bfloat16",
        "device": device,
    })
    knee_np, atlas_np = knee_and_atlas(**FULL)
    knee = image_from_array(knee_np, spacing=SPACING, device=device)
    atlas = image_from_array(atlas_np, spacing=SPACING, device=device)
    pipe = KneePipeline(
        segmenter,
        atlas,
        registration_config=None,  # adopt the shipped checkpoint's architecture
        instance_scales=(4, 2, 1),
        instance_steps=tuple(int(v) for v in os.environ.get("BENCH_INST_STEPS", "80,60,40").split(",")),
        registration_mode=os.environ.get("BENCH_REG_MODE", "auto"),
        finetune_steps=int(os.environ.get("BENCH_FT_STEPS", "20")),
        warp_dtype="bfloat16",
        device=device,
    )
    return pipe, knee


def _warmup_probe() -> None:
    """Subprocess mode: build the pipeline, run one knee, print the
    seconds."""
    t0 = time.perf_counter()
    pipe, knee = build_pipeline()
    pipe.run(knee)
    print(json.dumps({"warmup_seconds": round(time.perf_counter() - t0, 2)}))


def _measure_fresh_warmup() -> float:
    """What a fresh process pays up to the end of its first knee (the number
    `prewarm` is for), in a subprocess that runs before this process touches
    the card. Raises if the probe fails or prints no positive result."""
    res = subprocess.run(
        [sys.executable, "-m", "oai_analysis_2_tpu_torch.bench", "--warmup-probe"],
        capture_output=True, text=True, timeout=1800, cwd=Path(__file__).resolve().parents[1],
    )
    if res.returncode == 0:
        for line in reversed(res.stdout.strip().splitlines()):
            try:
                seconds = float(json.loads(line)["warmup_seconds"])
            except (ValueError, KeyError, TypeError):
                continue
            if np.isfinite(seconds) and seconds > 0:
                return seconds
    raise RuntimeError(f"the fresh-process warm-up probe failed (exit {res.returncode}):\n"
                       f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")


def main() -> dict:
    result_json = {
        "metric": "single-knee pipeline (seg+reg+warp+thickness), steady-state",
        "value": None,
        "unit": "knees/hour/card",
        "vs_baseline": None,
        "card": card_line(),
        "host_cpu": host_cpu(),
    }
    result_json["warmup_seconds_fresh_process"] = _measure_fresh_warmup()
    try:
        t_setup = time.perf_counter()
        pipe, knee = build_pipeline()
        pipe.run(knee)  # warm-up knee
        warm = time.perf_counter() - t_setup
        _reset_peak(pipe.device)
        native.reset_calls()

        def timed_knee():
            t0 = time.perf_counter()
            r = pipe.run(knee)
            return time.perf_counter() - t0, r

        samples = sorted((timed_knee() for _ in range(3)), key=lambda s: s[0])
        dt, result = samples[1]  # the median sample and its stage seconds
        native_calls = native.read_calls()
    except Exception as e:  # noqa: BLE001 — report, then fail
        result_json["error"] = f"headline phase failed: {e!r}"
        print(json.dumps(result_json))
        raise

    # sanity: the meshes come from the segmenter's own warped maps, so a
    # segment, warp or thickness regression shows as degenerate meshes
    fc_inner, tc_inner = result.fc_inner, result.tc_inner
    if not (fc_inner.n_points > 1000 and tc_inner.n_points > 1000):
        raise AssertionError(f"thickness stage produced degenerate meshes ({fc_inner.n_points}, {tc_inner.n_points})")
    fc_med = float(np.median(np.asarray(fc_inner.point_data)))
    if not 0.2 < fc_med < 10.0:
        raise AssertionError(f"implausible FC thickness median {fc_med}")

    knees_per_hour = 3600.0 / dt
    result_json.update({
        "value": round(knees_per_hour, 2),
        "vs_baseline": round(knees_per_hour / BASELINE_KNEES_PER_HOUR, 2),
        "seconds_per_knee": round(dt, 3),
        "knee_samples": [round(s, 3) for s, _ in samples],
        "warmup_seconds": round(warm, 2),
        "registration_mode": pipe.registerer.mode,
        "fc_mesh_points": int(fc_inner.n_points),
        "tc_mesh_points": int(tc_inner.n_points),
        "fc_thickness_median_mm": round(fc_med, 3),
        "stage_seconds": {k: v["seconds"] for k, v in result.timings.items()},
        "registration_quality": result.registration_quality,
        "peak_memory_gb": _peak_gb(pipe.device),
        # the host-geometry library's calls in the three timed knees: the
        # thickness stage's component filter and smoothing table
        "native_calls_3_knees": native_calls,
    })
    try:
        result_json.update(batched_phases(pipe, knee, dt, result.timings["segment"]["seconds"]))
    except Exception as e:  # noqa: BLE001 — report, then fail
        result_json["error"] = f"batched phase failed: {e!r}"
        print(json.dumps(result_json))
        raise
    print(json.dumps(result_json))
    return result_json


if __name__ == "__main__":
    if "--warmup-probe" in sys.argv:
        _warmup_probe()
    else:
        main()
