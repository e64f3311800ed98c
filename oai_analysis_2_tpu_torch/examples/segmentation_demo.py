"""Segmentation-only demo, the reference's SegmentationDemo.ipynb as a
module (port of `examples/segmentation_demo.py`).

Usage (on the card; needs the release tree, read from `OAI_TPU_DATA_DIR`):
    python -m oai_analysis_2_tpu_torch.examples.segmentation_demo <image_preprocessed.nii.gz> [out_dir]

Writes `FC_probmap.nii.gz` and `TC_probmap.nii.gz` into `out_dir`
(`seg_output` by default).
"""

import sys
import time
from pathlib import Path

import torch

from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject
from oai_analysis_2_tpu_torch.core.device import resolve_device, synchronize
from oai_analysis_2_tpu_torch.core.nifti import read_nifti, write_nifti


def main(argv=None, device=None) -> dict:
    """Run as the module's docstring says; returns the segment seconds
    (the card synchronized) and the two voxel counts above 0.5."""
    argv = sys.argv[1:] if argv is None else list(argv)
    image_path = argv[0]
    out_dir = Path(argv[1] if len(argv) > 1 else "seg_output")
    dev = resolve_device(device)
    out_dir.mkdir(parents=True, exist_ok=True)

    obj = AnalysisObject(device=dev)
    image = read_nifti(image_path, device=dev)
    t0 = time.time()
    fc_prob, tc_prob = obj.segment(image)
    synchronize(dev)
    dt = time.time() - t0
    fc_voxels = int(torch.sum(fc_prob.data > 0.5))
    tc_voxels = int(torch.sum(tc_prob.data > 0.5))
    print(f"segmented {tuple(image.data.shape)} in {dt:.2f}s")
    print("FC voxels > 0.5:", fc_voxels)
    print("TC voxels > 0.5:", tc_voxels)
    write_nifti(fc_prob, out_dir / "FC_probmap.nii.gz")
    write_nifti(tc_prob, out_dir / "TC_probmap.nii.gz")
    print("wrote", out_dir)
    return {"seconds": dt, "fc_voxels": fc_voxels, "tc_voxels": tc_voxels, "out_dir": str(out_dir)}


if __name__ == "__main__":
    main()
