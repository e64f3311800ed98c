"""Cohort demo, the reference's DaskComputation(Coiled).ipynb as a module
(port of `examples/cohort_demo.py`): a resumable work queue over a
directory of knee volumes, each through segment, register and thickness.

The JAX script fans out over hosts when `jax.distributed` is initialized;
the port runs on one card, and the runner claims every knee in this
process (`parallel/cohort.py` shares the work across processes only when
torch.distributed is initialized).

Usage (on the card; needs the release tree, read from `OAI_TPU_DATA_DIR`):
    python -m oai_analysis_2_tpu_torch.examples.cohort_demo <dir_with_nii_gz_volumes> [output_dir]

Writes each knee's VTK files and the manifest `manifest.json` into
`output_dir` (`cohort_output` by default).
"""

import sys
from pathlib import Path

from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject
from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.engine.pipeline import KneePipeline
from oai_analysis_2_tpu_torch.parallel.cohort import CohortRunner


def main(argv=None, device=None) -> dict:
    """Run as the module's docstring says; returns the runner's summary."""
    argv = sys.argv[1:] if argv is None else list(argv)
    in_dir = Path(argv[0])
    out_dir = Path(argv[1] if len(argv) > 1 else "cohort_output")
    dev = resolve_device(device)
    volumes = sorted(in_dir.glob("*.nii.gz"))
    if not volumes:
        raise SystemExit(f"no .nii.gz volumes in {in_dir}")

    obj = AnalysisObject(device=dev)
    pipe = KneePipeline(obj.segmenter, obj.atlas_image, device=dev)
    runner = CohortRunner(
        lambda p: pipe.run_path(p, output_dir=out_dir),
        manifest_path=out_dir / "manifest.json",
        max_retries=1,
    )
    summary = runner.run(volumes, keys=[v.name for v in volumes])
    print("cohort summary:", summary)
    return summary


if __name__ == "__main__":
    main()
