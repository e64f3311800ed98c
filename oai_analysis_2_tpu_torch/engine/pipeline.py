"""The single-knee pipeline: preprocess -> segment -> register -> warp ->
thickness (port of `oai_analysis_2_tpu/engine/pipeline.py:30-182`).

Every stage runs on the pipeline's device and feeds the next there; the
per-stage seconds are wall times with the card synchronized at each stage
end. Atlas products (2D thickness maps) and NIfTI I/O are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.core.image import Image
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
    registration_quality: Optional[dict] = None


class KneePipeline:
    """segment + register + warp + thickness for one knee volume."""

    def __init__(
        self,
        segmenter: Segmenter3DInPatchClassWise,
        atlas_image: Image,
        registration_config: Optional[GradICONConfig] = None,
        normalize: bool = True,
        registration_mode: str = "auto",
        finetune_steps: int = 0,
        warp_dtype: str = "float32",
        device=None,
    ):
        """registration_mode "auto"/"network" runs the shipped GradICON
        network; fine-tuning and instance optimization raise
        NotImplementedError (not ported yet). warp_dtype "bfloat16" gathers
        the probability maps in bf16 during the warp."""
        if warp_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"warp_dtype must be 'float32' or 'bfloat16', got {warp_dtype!r}")
        self.device = resolve_device(device)
        self.segmenter = segmenter
        self.atlas = atlas_image.to(self.device)
        self.normalize = normalize
        self.warp_dtype = warp_dtype
        self.registerer = ICON_Registration(
            mode=registration_mode, config=registration_config,
            finetune_steps=finetune_steps, device=self.device,
        )
        self.reg_config = self.registerer.config

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

        return KneeResult(
            fc_probmap=fc_w,
            tc_probmap=tc_w,
            fc_inner=fc_inner,
            fc_outer=fc_outer,
            tc_inner=tc_inner,
            tc_outer=tc_outer,
            timings=timer.report(),
            registration_quality=self.registerer.last_quality,
        )
