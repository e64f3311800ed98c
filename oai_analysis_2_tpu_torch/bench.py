"""Single-knee pipeline benchmark on the card (port of the headline phase of
the repo-root `bench.py:87-330`, which imports JAX).

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
name and power limit, the host CPU and `peak_memory_gb`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

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
    import torch

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
        torch.cuda.reset_peak_memory_stats()

        def timed_knee():
            t0 = time.perf_counter()
            r = pipe.run(knee)
            return time.perf_counter() - t0, r

        samples = sorted((timed_knee() for _ in range(3)), key=lambda s: s[0])
        dt, result = samples[1]  # the median sample and its stage seconds
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
        "peak_memory_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
    })
    print(json.dumps(result_json))
    return result_json


if __name__ == "__main__":
    if "--warmup-probe" in sys.argv:
        _warmup_probe()
    else:
        main()
