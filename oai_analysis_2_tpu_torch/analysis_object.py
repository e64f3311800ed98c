"""One-stop analysis facade (port of `oai_analysis_2_tpu/analysis_object.py`).

Built from the release layout on disk: `models_path` holds
`segmentation_model.pth.tar` (the reference's torch checkpoint, preferred)
or `segmentation_model.npz`, and `segmentation_train_config.pth.tar` (JSON);
`atlas_path` is `atlas_image.nii.gz`, whose directory (`atlas_dir`) also
holds the atlas probability maps `atlas_fc.nii.gz` / `atlas_tc.nii.gz`.
`None` for either takes the release tree from `utils.data` (a pre-seeded
`OAI_TPU_DATA_DIR` needs no network).

`AnalysisObject.offline()` needs no download: a deterministic synthetic
atlas (`random_phantom` with rng seed 60, as the JAX package builds it) and
the full production `UNet` with threshold weights written once to
`build/phantom_models/` at the root of the checkout (beside the kernels'
`build/kernels/`).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.core.image import Image, image_from_array
from oai_analysis_2_tpu_torch.core.nifti import read_nifti
from oai_analysis_2_tpu_torch.engine.registration import ICON_Registration
from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise
from oai_analysis_2_tpu_torch.models.synthetic import random_phantom
from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS, make_threshold_params
from oai_analysis_2_tpu_torch.utils.checkpoint import save_checkpoint

#: sentinel for offline construction; "phantom:D,H,W" for another grid
PHANTOM = "phantom"


def _parse_phantom_shape(spec: str, default=(160, 384, 384)) -> Tuple[int, int, int]:
    _, _, dims = spec.partition(":")
    if not dims:
        return default
    shape = tuple(int(v) for v in dims.split(","))
    if len(shape) != 3 or any(s <= 0 for s in shape):
        raise ValueError(f"bad phantom shape spec {spec!r}; want 'phantom:D,H,W'")
    return shape


def _phantom_atlas(shape_zyx, device) -> Image:
    vol = random_phantom(np.random.default_rng(60), shape_zyx)
    return image_from_array(vol, spacing=(0.36, 0.36, 0.7), device=device)


def _phantom_models_dir() -> Path:
    """Write (once) a models/ tree shaped like the release tarball: the full
    production `UNet` with threshold weights computing sigmoid(24*(x-0.5))."""
    cache = Path(__file__).resolve().parents[1] / "build" / "phantom_models"
    ckpt = cache / "segmentation_model.npz"
    cfg = cache / "segmentation_train_config.pth.tar"  # JSON; the reference names it so
    if not (ckpt.exists() and cfg.exists()):
        params = make_threshold_params(NETWORK_SPECS["UNet"].replace(bias=True), gain=24.0, threshold=0.5)
        save_checkpoint({"params": params, "epoch": 600}, ckpt)
        cfg_tmp = cache / f"segmentation_train_config.tmp{os.getpid()}"
        cfg_tmp.write_text(json.dumps({
            "patch_size": [128, 128, 32],
            "model": "UNet",
            "model_setting": {"in_channels": 1, "n_classes": 2, "bias": True, "BN": False},
        }))
        os.replace(cfg_tmp, cfg)
    return cache


class AnalysisObject:
    def __init__(
        self,
        models_path: Optional[Union[Path, str]] = None,
        atlas_path: Optional[Union[Path, str]] = None,
        batch_size: int = 4,
        overlap_size: Tuple[int, int, int] = (16, 16, 8),
        compute_dtype: str = "bfloat16",
        registration_mode: str = "auto",
        registration_steps=60,
        device=None,
    ):
        self.device = resolve_device(device)
        if isinstance(models_path, str) and models_path.startswith(PHANTOM):
            models_path = _phantom_models_dir()
        elif models_path is None:
            from oai_analysis_2_tpu_torch.utils.data import models_dir

            try:
                models_path = models_dir()
            except Exception as e:  # noqa: BLE001 — downloads fail offline
                raise RuntimeError(
                    "could not fetch the release models tarball; pre-seed "
                    "OAI_TPU_DATA_DIR, pass models_path=..., or use "
                    "models_path='phantom' for an offline threshold-weights "
                    "segmenter"
                ) from e
        models_path = Path(models_path)
        ckpt = models_path / "segmentation_model.pth.tar"
        if not ckpt.exists() and (models_path / "segmentation_model.npz").exists():
            ckpt = models_path / "segmentation_model.npz"
        self.segmenter = Segmenter3DInPatchClassWise(mode="pred", config=dict(
            ckpoint_path=str(ckpt),
            training_config_file=str(models_path / "segmentation_train_config.pth.tar"),
            batch_size=batch_size,
            overlap_size=overlap_size,
            output_prob=True,
            output_itk=True,
            compute_dtype=compute_dtype,
            device=self.device,
        ))
        # registration_steps: instance-optimization steps per scale (an int or
        # one count per scale), for mode "instance" or an "auto" that
        # resolves to it
        self.registerer = ICON_Registration(mode=registration_mode, instance_steps=registration_steps,
                                            device=self.device)
        # the directory of the atlas artifacts (atlas_fc/tc.nii.gz beside
        # atlas_image.nii.gz); None for phantoms
        self.atlas_dir: Optional[Path] = None
        if isinstance(atlas_path, str) and atlas_path.startswith(PHANTOM):
            self.atlas_image: Image = _phantom_atlas(_parse_phantom_shape(atlas_path), self.device)
        else:
            if atlas_path is None:
                from oai_analysis_2_tpu_torch.utils.data import atlases_dir

                try:
                    atlas_path = atlases_dir() / "atlas_60_LEFT_baseline_NMI" / "atlas_image.nii.gz"
                except Exception as e:  # noqa: BLE001 — downloads fail offline
                    raise RuntimeError(
                        "could not fetch the release atlas tarball; pre-seed "
                        "OAI_TPU_DATA_DIR, pass atlas_path=..., or use "
                        "atlas_path='phantom' for an offline synthetic atlas"
                    ) from e
            self.atlas_image = read_nifti(atlas_path, device=self.device)
            self.atlas_dir = Path(atlas_path).parent

    @classmethod
    def offline(cls, atlas_shape: str = "phantom", **kwargs) -> "AnalysisObject":
        """Construct with zero downloads: synthetic atlas + threshold-weights
        production-topology segmenter."""
        kwargs.setdefault("models_path", PHANTOM)
        kwargs.setdefault("atlas_path", atlas_shape)
        return cls(**kwargs)

    def segment(self, preprocessed_image: Image) -> Tuple[Image, Image]:
        """(FC_probmap, TC_probmap)."""
        return self.segmenter.segment(preprocessed_image.to(self.device), if_output_prob_map=True,
                                      if_output_itk=True)

    def register(self, preprocessed_image: Image):
        """Displacement transform warping knee-grid data onto the atlas grid."""
        return self.registerer.register(preprocessed_image.to(self.device), self.atlas_image)
