"""Command-line interface (port of `oai_analysis_2_tpu/__main__.py`):

    python -m oai_analysis_2_tpu_torch segment  <image.nii.gz> [-o out_dir] [--device cuda]
    python -m oai_analysis_2_tpu_torch pipeline <image.nii.gz> [-o out_dir] [--device cuda]
        [--registration-mode auto|network|instance] [--finetune-steps 20]
    python -m oai_analysis_2_tpu_torch cohort   <dir_of_volumes> [-o out_dir] [--device cuda]
        [--registration-mode auto|network|instance] [--finetune-steps 20]
    python -m oai_analysis_2_tpu_torch bench
    python -m oai_analysis_2_tpu_torch prewarm [--shape D,H,W] [--device cuda] [...]

`segment`, `pipeline` and `cohort` build `AnalysisObject()` from the release
layout (`OAI_TPU_DATA_DIR`, see `utils/data.py`). `segment` writes
FC_probmap.nii.gz and TC_probmap.nii.gz; `pipeline` runs
`KneePipeline.run_path` and prints its metadata; `cohort` runs every
`*.nii.gz` of a directory through `parallel.CohortRunner` (resumable
manifest `manifest.json` in the output directory; the next knee is decoded
on the host while the current one computes). `bench` runs the port's
single-knee benchmark (`oai_analysis_2_tpu_torch/bench.py`), `prewarm` one
phantom knee (`engine/prewarm.py`).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(prog="oai_analysis_2_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("segment", "pipeline"):
        p = sub.add_parser(name)
        p.add_argument("image", type=Path)
        p.add_argument("-o", "--output", type=Path, default=Path(f"{name}_output"))
    p = sub.add_parser("cohort")
    p.add_argument("directory", type=Path)
    p.add_argument("-o", "--output", type=Path, default=Path("cohort_output"))
    for name in ("segment", "pipeline", "cohort"):
        sub.choices[name].add_argument("--device", default="cuda",
                                       help="torch device to run on ('cpu' runs the plain versions)")
    for name in ("pipeline", "cohort"):
        p = sub.choices[name]
        p.add_argument(
            "--registration-mode", default="auto", choices=("auto", "network", "instance"),
            help="auto: shipped GradICON net when present (fast); "
            "instance: per-pair optimization (most accurate, no weights)",
        )
        p.add_argument("--finetune-steps", type=int, default=20,
                       help="per-pair refinement steps on top of the network prediction")
    sub.add_parser("bench")
    sub.add_parser("prewarm", add_help=False, help="warm the production pipeline before the first real knee")

    if argv is None:
        import sys

        argv = sys.argv[1:]
    if argv and argv[0] == "prewarm":
        # its own parser (--shape, --registration-mode, --finetune-steps, --device)
        from oai_analysis_2_tpu_torch.engine import prewarm

        return prewarm.main(argv[1:])
    args = parser.parse_args(argv)
    if args.cmd == "bench":
        from oai_analysis_2_tpu_torch import bench

        return bench.main()

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
    if args.cmd == "pipeline":
        meta = pipe.run_path(args.image, output_dir=args.output)
        print(meta)
        return meta

    from oai_analysis_2_tpu_torch.parallel.cohort import CohortRunner

    def decode(path):
        """The prefetch thread's work: read and decode on the host, so no
        copy to the card queues behind the running knee's kernels."""
        t0 = time.perf_counter()
        image = read_nifti(path, device="cpu")
        return path, image, time.perf_counter() - t0

    def run_knee(prepared):
        path, image, decode_seconds = prepared
        meta = pipe.run_path(path, output_dir=args.output, image=image)
        meta["decode_seconds"] = round(decode_seconds, 4)
        return meta

    volumes = sorted(args.directory.glob("*.nii.gz"))
    runner = CohortRunner(run_knee, prepare=decode, manifest_path=args.output / "manifest.json")
    summary = runner.run(volumes, keys=[v.name for v in volumes])
    print(summary)
    return summary


if __name__ == "__main__":
    main()
