"""Phase 13 of `chip_smoke.py` alone: the port's multi-card path
(`parallel/sharding.py`, `BatchKneePipeline(mesh=...)`) in one process a
rank, on every card of the machine.

    python3 tools/port_sharding.py

It builds the kernel libraries and the host-geometry library, runs phase
10 (b)'s knee batch unsharded (two full-size knees, network + 20
fine-tuning steps, bf16 warp) for the meshes that phase 13 (e) is held
against, then `chip_smoke.sharding`: one rank a card over NCCL where
there are two or more cards, else two ranks on the one card over gloo.
Every gate of phase 13 is fatal. Prints each rank's report and writes all
of them to `chiprun_out/port_sharding_<n>cards.json`.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    from oai_analysis_2_tpu_torch import native
    from oai_analysis_2_tpu_torch.bench import FULL, card_line, knee_and_atlas
    from oai_analysis_2_tpu_torch.core.image import image_from_array
    from oai_analysis_2_tpu_torch.ops import cuda_build
    from oai_analysis_2_tpu_torch.parallel import BatchKneePipeline

    if not torch.cuda.is_available():
        print("port_sharding: this script needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, torch.__version__, torch.version.cuda, f"{torch.cuda.device_count()} card(s)", flush=True)
    t0 = time.perf_counter()
    cuda_build.build_all()
    native.build()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    pipe, knee = chip_smoke.build_pipeline("cuda", FULL, batch_size=8)
    knees = [knee, image_from_array(knee_and_atlas(**dict(FULL, **chip_smoke.SECOND_KNEE_SHELLS), seed=1)[0],
                                    spacing=(0.36, 0.36, 0.7), device="cuda")]
    bpipe = BatchKneePipeline(pipe.segmenter, pipe.atlas, registration_mode="network", finetune_steps=20,
                              warp_dtype="bfloat16", device="cuda")
    ref = [chip_smoke.summarize(r) for r in bpipe.run_batch(knees)]
    print(f"unsharded knee batch (the reference meshes) in {time.perf_counter() - t0:.1f} s", flush=True)
    del pipe, knee, knees, bpipe
    shard = chip_smoke.sharding(torch, card, ref)
    for r in shard["per_rank"]:
        print(json.dumps({k: r[k] for k in ("rank", "card", "a", "b", "c", "d")}), flush=True)
        print(json.dumps({k: v for k, v in r["e"].items() if k != "knees"}), json.dumps(r["f"]), flush=True)
    out = ROOT / "chiprun_out" / f"port_sharding_{torch.cuda.device_count()}cards.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(shard))
    print(f"phase 13 passed in {shard['phase_s']:.1f} s ({shard['ranks']} ranks over {shard['backend']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
