"""The single-knee pipeline: preprocess -> segment -> register -> warp ->
thickness [-> atlas_map] (port of `oai_analysis_2_tpu/engine/pipeline.py:30-182`).

Every stage runs on the pipeline's device and feeds the next there; the
per-stage seconds are wall times with the card synchronized at each stage
end. `run_path` reads a NIfTI knee and writes the meshes, the atlas maps
and a metadata dict, timing the read and the writes apart from `run`.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.core.image import Image
from oai_analysis_2_tpu_torch.core.nifti import read_nifti
from oai_analysis_2_tpu_torch.engine.atlas_products import AtlasThicknessMapper, thickness_map_stats
from oai_analysis_2_tpu_torch.engine.registration import ICON_Registration
from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise
from oai_analysis_2_tpu_torch.mesh.processing import get_thickness_meshes
from oai_analysis_2_tpu_torch.mesh.types import Mesh
from oai_analysis_2_tpu_torch.models.gradicon import GradICONConfig
from oai_analysis_2_tpu_torch.ops.intensity import percentile_window
from oai_analysis_2_tpu_torch.ops.resample import resample_images
from oai_analysis_2_tpu_torch.utils.profiling import StageTimer


@dataclasses.dataclass
class KneeResult:
    fc_probmap: Image
    tc_probmap: Image
    fc_inner: Mesh
    fc_outer: Mesh
    tc_inner: Mesh
    tc_outer: Mesh
    timings: dict
    # atlas-mapped 2D thickness products (AtlasThicknessMapper.map_knee),
    # with atlas_products
    thickness_2d: Optional[dict] = None
    registration_quality: Optional[dict] = None


class KneePipeline:
    """segment + register + warp + thickness (+ atlas maps) for one knee."""

    def __init__(
        self,
        segmenter: Segmenter3DInPatchClassWise,
        atlas_image: Image,
        registration_config: Optional[GradICONConfig] = None,
        instance_scales: Tuple[int, ...] = (4, 2, 1),
        instance_steps=(80, 60, 40),
        normalize: bool = True,
        registration_mode: str = "auto",
        finetune_steps: int = 0,
        finetune_scales: Tuple[int, ...] = (2,),
        finetune_lr: float = 0.15,
        warp_dtype: str = "float32",
        atlas_products=False,
        atlas_dir: Optional[Path] = None,
        device=None,
    ):
        """registration_mode: "auto" runs the shipped GradICON network when
        its weights match (one forward pass + `finetune_steps` of per-pair
        refinement), else instance optimization; or force "network" /
        "instance". warp_dtype "bfloat16" gathers the probability maps in
        bf16 during the warp. atlas_products: True (or a prebuilt
        `AtlasThicknessMapper`) also maps each knee's inner thickness onto
        the atlas meshes and a fixed 2D grid (`KneeResult.thickness_2d`);
        the atlas meshes come from `atlas_dir`'s probability maps
        (atlas_fc/tc.nii.gz) or, without them, from segmenting the atlas
        image once."""
        if warp_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"warp_dtype must be 'float32' or 'bfloat16', got {warp_dtype!r}")
        self.device = resolve_device(device)
        self.segmenter = segmenter
        self.atlas = atlas_image.to(self.device)
        self.normalize = normalize
        self.warp_dtype = warp_dtype
        self.registerer = ICON_Registration(
            mode=registration_mode, config=registration_config,
            instance_steps=instance_steps, instance_scales=instance_scales,
            finetune_steps=finetune_steps, finetune_scales=finetune_scales, finetune_lr=finetune_lr,
            device=self.device,
        )
        self.reg_config = self.registerer.config
        self.atlas_products = bool(atlas_products)
        self.atlas_dir = atlas_dir
        self._atlas_mapper = atlas_products if isinstance(atlas_products, AtlasThicknessMapper) else None

    def _get_mapper(self) -> AtlasThicknessMapper:
        """The atlas meshes' 2D embedding, built on first use: it depends on
        the atlas alone."""
        if self._atlas_mapper is None:
            self._atlas_mapper = AtlasThicknessMapper.from_segmenter(
                self.segmenter, self.atlas, atlas_dir=self.atlas_dir
            )
        return self._atlas_mapper

    def run(self, image: Image) -> KneeResult:
        timer = StageTimer(self.device)
        image = image.to(self.device)
        with timer.stage("preprocess"):
            pre = percentile_window(image, 0.1, 99.9, 0.0, 1.0) if self.normalize else image

        with timer.stage("segment"):
            fc, tc = self.segmenter.segment(pre, if_output_prob_map=True)

        with timer.stage("register"):
            phi_ab = self.registerer.register(pre, self.atlas)

        with timer.stage("warp"):
            wdt = torch.bfloat16 if self.warp_dtype == "bfloat16" else None
            fc_w, tc_w = resample_images([fc, tc], self.atlas, displacement=phi_ab, compute_dtype=wdt)

        with timer.stage("thickness"):
            (fc_inner, fc_outer), (tc_inner, tc_outer) = get_thickness_meshes([fc_w, tc_w], ["FC", "TC"])

        thickness_2d = None
        if self.atlas_products:
            with timer.stage("atlas_map"):
                thickness_2d = self._get_mapper().map_knee(fc_inner, tc_inner)

        return KneeResult(
            fc_probmap=fc_w,
            tc_probmap=tc_w,
            fc_inner=fc_inner,
            fc_outer=fc_outer,
            tc_inner=tc_inner,
            tc_outer=tc_outer,
            timings=timer.report(),
            thickness_2d=thickness_2d,
            registration_quality=self.registerer.last_quality,
        )

    def run_path(self, nifti_path, output_dir: Optional[Path] = None, image: Optional[Image] = None) -> dict:
        """Read a NIfTI knee (unless `image` is given), run it, and write
        `<stem>_{FC,TC}_{inner,outer}.vtk` and, with atlas products,
        `<stem>_thickness_2d.npz` into `output_dir`. Returns the JSON-ready
        metadata of the JAX package's `run_path` (`engine/pipeline.py:184-220`)
        plus `read_seconds` and `write_seconds`, the host time of the read
        and of the writes."""
        t0 = time.perf_counter()
        image = read_nifti(nifti_path, device=self.device) if image is None else image
        read_seconds = time.perf_counter() - t0
        result = self.run(image)
        meta = {
            "input": str(nifti_path),
            "timings": result.timings,
            "fc_points": result.fc_inner.n_points,
            "tc_points": result.tc_inner.n_points,
        }
        if result.registration_quality is not None:
            meta["registration_quality"] = result.registration_quality
        if result.thickness_2d is not None:
            meta.update(thickness_map_stats(result.thickness_2d))
        t0 = time.perf_counter()
        if output_dir is not None:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            stem = Path(str(nifti_path)).name.split(".")[0]
            result.fc_inner.save_vtk(output_dir / f"{stem}_FC_inner.vtk")
            result.tc_inner.save_vtk(output_dir / f"{stem}_TC_inner.vtk")
            result.fc_outer.save_vtk(output_dir / f"{stem}_FC_outer.vtk")
            result.tc_outer.save_vtk(output_dir / f"{stem}_TC_outer.vtk")
            if result.thickness_2d is not None:
                t2d = output_dir / f"{stem}_thickness_2d.npz"
                np.savez_compressed(t2d, **result.thickness_2d)
                meta["thickness_2d"] = str(t2d)
            meta["outputs"] = str(output_dir)
        meta["read_seconds"] = round(read_seconds, 4)
        meta["write_seconds"] = round(time.perf_counter() - t0, 4)
        return meta
