from oai_analysis_2_tpu_torch.ops.intensity import (
    checkerboard,
    comparison_sum,
    intensity_window,
    normalize_image,
    percentile_window,
)
from oai_analysis_2_tpu_torch.ops.tiling import Partition
from oai_analysis_2_tpu_torch.ops.resample import (
    DisplacementField,
    resample_image,
    resample_images,
    resample_with_displacement,
    sample_at_physical_points,
)

__all__ = [
    "checkerboard",
    "comparison_sum",
    "intensity_window",
    "normalize_image",
    "percentile_window",
    "Partition",
    "DisplacementField",
    "resample_image",
    "resample_images",
    "resample_with_displacement",
    "sample_at_physical_points",
]
