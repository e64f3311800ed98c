"""Command-line interface (port of `oai_analysis_2_tpu/__main__.py`):

    python -m oai_analysis_2_tpu_torch segment  <image.nii.gz> [-o out_dir] [--device cuda]
    python -m oai_analysis_2_tpu_torch pipeline <image.nii.gz> [-o out_dir] [--device cuda]
        [--registration-mode auto|network|instance] [--finetune-steps 20]

Both build `AnalysisObject()` from the release layout (`OAI_TPU_DATA_DIR`,
see `utils/data.py`). `segment` writes FC_probmap.nii.gz and
TC_probmap.nii.gz; `pipeline` runs `KneePipeline.run_path` and prints its
metadata. The JAX package's `cohort`, `bench` and `prewarm` commands are
not ported yet (ROADMAP.md, Queue 1 item 3).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(prog="oai_analysis_2_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("segment", "pipeline"):
        p = sub.add_parser(name)
        p.add_argument("image", type=Path)
        p.add_argument("-o", "--output", type=Path, default=Path(f"{name}_output"))
        p.add_argument("--device", default="cuda", help="torch device to run on ('cpu' runs the plain versions)")
    p = sub.choices["pipeline"]
    p.add_argument(
        "--registration-mode", default="auto", choices=("auto", "network", "instance"),
        help="auto: shipped GradICON net when present (fast); "
        "instance: per-pair optimization (most accurate, no weights)",
    )
    p.add_argument("--finetune-steps", type=int, default=20,
                   help="per-pair refinement steps on top of the network prediction")
    args = parser.parse_args(argv)

    from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject
    from oai_analysis_2_tpu_torch.core.nifti import read_nifti, write_nifti

    obj = AnalysisObject(device=args.device)
    args.output.mkdir(parents=True, exist_ok=True)
    if args.cmd == "segment":
        fc, tc = obj.segment(read_nifti(args.image, device=obj.device))
        write_nifti(fc, args.output / "FC_probmap.nii.gz")
        write_nifti(tc, args.output / "TC_probmap.nii.gz")
        print("wrote", args.output)
        return None
    from oai_analysis_2_tpu_torch.engine.pipeline import KneePipeline

    pipe = KneePipeline(
        obj.segmenter, obj.atlas_image,
        registration_mode=args.registration_mode,
        finetune_steps=args.finetune_steps,
        device=obj.device,
    )
    meta = pipe.run_path(args.image, output_dir=args.output)
    print(meta)
    return meta


if __name__ == "__main__":
    main()
