from oai_analysis_2_tpu_torch.core.image import Image, image_from_array, physical_grid
from oai_analysis_2_tpu_torch.core.nifti import read_nifti, write_nifti

__all__ = ["Image", "image_from_array", "physical_grid", "read_nifti", "write_nifti"]
