"""Stage-level functional API (port of `oai_analysis_2_tpu/engine/stages.py:22-109`).

Each function mirrors one task of the reference's Dask layer
(`dask_processing.py`) as a plain function. Entry points that create data
take `device` (None: the card). `readimage` reads NIfTI; zarr stores and
remote URLs raise until the zarr reader is ported (ROADMAP.md, Queue 1
item 3).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

from oai_analysis_2_tpu_torch.core.image import Image
from oai_analysis_2_tpu_torch.core.nifti import read_nifti
from oai_analysis_2_tpu_torch.engine.registration import register_pair
from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise
from oai_analysis_2_tpu_torch.mesh.processing import get_thickness_mesh
from oai_analysis_2_tpu_torch.models.gradicon import GradICONConfig
from oai_analysis_2_tpu_torch.ops.intensity import percentile_window
from oai_analysis_2_tpu_torch.ops.resample import DisplacementField, resample_image


def image_normalize(
    image: Image,
    window_min_perc: float = 0.1,
    window_max_perc: float = 99.9,
    output_min: float = 0.0,
    output_max: float = 1.0,
) -> Image:
    """Percentile window onto [output_min, output_max]."""
    return percentile_window(image, window_min_perc, window_max_perc, output_min, output_max)


def readimage(image_path, device=None) -> Image:
    """Load a NIfTI volume onto `device`."""
    remote = isinstance(image_path, str) and image_path.startswith(("s3://", "http://", "https://"))
    p = Path(image_path)
    if remote or p.suffix == ".zarr" or (p / ".zarray").exists() or (p / "image" / ".zarray").exists():
        raise NotImplementedError(
            f"reading zarr stores and remote URLs ({image_path}) is not ported yet "
            "(ROADMAP.md, Queue 1 item 3); pass a NIfTI file"
        )
    return read_nifti(p, device=device)


def register_images(
    image_a_path,
    image_b_path,
    config: Optional[GradICONConfig] = None,
    instance_steps: int = 60,
    device=None,
) -> Tuple[DisplacementField, Image, Image]:
    """Load both images, normalize A, register by instance optimization;
    returns (phi_AB, image_A, image_B)."""
    image_a = image_normalize(readimage(image_a_path, device))
    image_b = readimage(image_b_path, device)
    phi_ab, _ = register_pair(image_a, image_b, config=config, instance_steps=instance_steps)
    return phi_ab, image_a, image_b


def deform_probmap(
    phi_ab: DisplacementField, image_a: Image, image_b: Image, prob: Image, image_type: str = "FC",
) -> Image:
    """Warp a probability map from A's grid onto B's grid through phi_AB."""
    return resample_image(prob, image_b, displacement=phi_ab)


def get_thickness(warped_image: Image, mesh_type: str):
    """The inner-surface thickness mesh of a warped probability map."""
    distance_inner, _ = get_thickness_mesh(warped_image, mesh_type=mesh_type)
    return distance_inner


def segment_method(
    image_a_path,
    models_path,
    batch_size: int = 2,
    overlap_size: Tuple[int, int, int] = (16, 16, 8),
    device=None,
) -> Tuple[Image, Image]:
    """Build a segmenter from the release's model files (the `.pth.tar`
    checkpoint, else `.npz`), normalize the image, segment it."""
    models_path = Path(models_path)
    ckpt = models_path / "segmentation_model.pth.tar"
    if not ckpt.exists():
        ckpt = models_path / "segmentation_model.npz"
    segmenter = Segmenter3DInPatchClassWise(mode="pred", config=dict(
        ckpoint_path=str(ckpt),
        training_config_file=str(models_path / "segmentation_train_config.pth.tar"),
        batch_size=batch_size,
        overlap_size=overlap_size,
        output_prob=True,
        output_itk=True,
        device=device,
    ))
    volume = image_normalize(readimage(image_a_path, device))
    return segmenter.segment(volume, if_output_prob_map=True, if_output_itk=True)
