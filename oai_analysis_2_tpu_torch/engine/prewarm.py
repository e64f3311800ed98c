"""Prewarm: pay the pipeline's first-knee cost before real data arrives (port
of `oai_analysis_2_tpu/engine/prewarm.py:28-121`).

A fresh process pays, on its first knee, what later knees do not: nvcc
builds of the kernel libraries that `build/kernels/` lacks and the g++
build of the host-geometry library that `build/native/` lacks (the
libraries are cached there across processes), loading them, the CUDA
context and the caching allocator's first large allocations. A
long-lived cohort worker should pay that at deploy time, so `python -m
oai_analysis_2_tpu_torch prewarm` (or this function) runs one phantom
knee through the full pipeline at the production grid: later processes
on the host find the libraries built, and the calling process is left
warm.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np


def _built_libraries() -> int:
    """Libraries present for the current sources and flags: the kernel
    libraries in `build/kernels/` (`cuda_build.library_path`, one per name
    of `cuda_build.EXTRA_FLAGS`) and the host-geometry library in
    `build/native/` (`native.library_path`)."""
    from oai_analysis_2_tpu_torch import native
    from oai_analysis_2_tpu_torch.ops import cuda_build

    kernels = sum(cuda_build.library_path(name).exists() for name in cuda_build.EXTRA_FLAGS)
    return kernels + int(native.library_path().exists())


def prewarm(
    analysis_object=None,
    shape_zyx: Tuple[int, int, int] = (160, 384, 384),
    spacing_zyx: Tuple[float, float, float] = (0.7, 0.36, 0.36),
    registration_mode: str = "auto",
    finetune_steps: int = 20,
    instance_steps=(80, 60, 40),
    thickness: bool = True,
    seed: int = 0,
    device=None,
) -> dict:
    """Run one phantom knee through the full pipeline at `shape_zyx` on
    `device` (None: the card).

    Returns the JAX package's report keys: import / build / first-knee
    seconds, the stage seconds, and `compile_cache_entries_before` /
    `_after`, which here count the kernel libraries present in
    `build/kernels/` (`cuda_build.library_path(name).exists()` for each name
    in `cuda_build.EXTRA_FLAGS`) before and after the knee.

    `thickness` is the JAX signature's, where nothing reads it: the knee
    always runs its thickness stage, so `thickness=False` is refused rather
    than ignored.
    """
    if not thickness:
        raise ValueError("prewarm always runs the thickness stage; thickness=False is not supported")
    t0 = time.time()
    from oai_analysis_2_tpu_torch import native
    from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject
    from oai_analysis_2_tpu_torch.core.image import image_from_array
    from oai_analysis_2_tpu_torch.engine.pipeline import KneePipeline
    from oai_analysis_2_tpu_torch.models.synthetic import random_phantom

    t_import = time.time() - t0

    cache_before = _built_libraries()

    t0 = time.time()
    native.build()
    if analysis_object is None:
        analysis_object = AnalysisObject.offline("phantom:%d,%d,%d" % tuple(shape_zyx), device=device)
    rng = np.random.default_rng(seed)
    knee = image_from_array(
        random_phantom(rng, tuple(shape_zyx)).astype(np.float32),
        spacing=tuple(spacing_zyx)[::-1],
        device=analysis_object.device,
    )
    pipe = KneePipeline(
        analysis_object.segmenter,
        analysis_object.atlas_image,
        registration_config=None,  # adopt the shipped checkpoint's architecture
        instance_steps=tuple(instance_steps),
        registration_mode=registration_mode,
        finetune_steps=finetune_steps,
        warp_dtype="bfloat16",
        device=analysis_object.device,
    )
    t_build = time.time() - t0

    t0 = time.time()
    result = pipe.run(knee)
    t_first = time.time() - t0

    return {
        "import_seconds": round(t_import, 1),
        "build_seconds": round(t_build, 1),
        "first_knee_seconds": round(t_first, 1),
        "prewarm_seconds": round(t_import + t_build + t_first, 1),
        "stage_seconds": {k: v["seconds"] for k, v in result.timings.items()},
        "compile_cache_entries_before": cache_before,
        "compile_cache_entries_after": _built_libraries(),
        "shape_zyx": list(shape_zyx),
        "registration_mode": pipe.registerer.mode,
    }


def main(argv: Optional[list] = None) -> dict:
    """CLI entry: `python -m oai_analysis_2_tpu_torch prewarm [...]`."""
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="oai_analysis_2_tpu_torch prewarm")
    parser.add_argument("--shape", default="160,384,384",
                        help="z,y,x production grid to warm (default: reference OAI grid)")
    parser.add_argument("--registration-mode", default="auto", choices=("auto", "network", "instance"))
    parser.add_argument("--finetune-steps", type=int, default=20)
    parser.add_argument("--device", default="cuda", help="torch device to run on ('cpu' runs the plain versions)")
    args = parser.parse_args(argv)

    shape = tuple(int(v) for v in args.shape.split(","))
    if len(shape) != 3:
        raise SystemExit(f"--shape wants 'D,H,W', got {args.shape!r}")
    report = prewarm(
        shape_zyx=shape,
        registration_mode=args.registration_mode,
        finetune_steps=args.finetune_steps,
        device=args.device,
    )
    print(json.dumps(report))
    return report
