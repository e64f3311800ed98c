"""What the process-wide TF32 switches do to the port's f32 products on the
card, with `core.device.ieee_f32_matmul` guarding them and without.

    python3 tools/port_tf32_gaps.py [--out FILE]

Builds the kernels, makes `chip_smoke.py` phase 4's pipeline (the bench
fixture knee, the production UNet, the shipped GradICON in network mode)
and computes `chip_smoke.tf32_products` (`GradICON.both_maps`, the warp's
upsampled field, the device k-means labels and centres of the knee's
split problems, the knee's warped maps) three times: with the switches
off, with both on (`allow_tf32 = True`, `set_float32_matmul_precision
("high")`), and with both on and the guards made no-ops, as the products
ran before the guards. Prints one JSON object with each product's
largest gap from the switch-off result and the count of elements that
differ; also written to `--out` (default
`chiprun_out/port_tf32_gaps.json`). About 2 minutes on the card machine.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from oai_analysis_2_tpu_torch import native  # noqa: E402
from oai_analysis_2_tpu_torch.bench import FULL, card_line  # noqa: E402
from oai_analysis_2_tpu_torch.models import unet3d  # noqa: E402
from oai_analysis_2_tpu_torch.ops import clustering, cuda_build, resample  # noqa: E402

GUARDED = (unet3d, clustering, resample)  # the modules whose f32 products the guard holds


def gaps(got: dict, ref: dict) -> dict:
    return {k: {"max_abs": float(np.max(np.abs(got[k].astype(np.float64) - ref[k]))) if ref[k].size else 0.0,
                "differ": int(np.sum(got[k] != ref[k])), "size": int(ref[k].size)} for k in ref}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "port_tf32_gaps.json"))
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("port_tf32_gaps: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all()
    native.build()
    pipe, knee = chip_smoke.build_pipeline("cuda", FULL, batch_size=8)
    result = pipe.run(knee)
    specs = chip_smoke.split_specs([(result.fc_probmap, result.tc_probmap)])
    problems = [p for probs, _ in specs for p in probs]
    field = pipe.registerer.register(knee, pipe.atlas)

    def products():
        return chip_smoke.tf32_products(torch, pipe, knee, field, problems)

    off = products()
    guards = {m: m.ieee_f32_matmul for m in GUARDED}
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        guarded = products()
        for m in GUARDED:
            m.ieee_f32_matmul = contextlib.nullcontext
        unguarded = products()
    finally:
        for m, guard in guards.items():
            m.ieee_f32_matmul = guard
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    report = {"card": card_line(), "torch": torch.__version__, "guarded": gaps(guarded, off),
              "unguarded": gaps(unguarded, off), "switches_off_again": gaps(products(), off)}
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
