"""The port's registration against the JAX package's, on the CPU, on
chip_smoke.py's phantom knees at production grid size.

    JAX_PLATFORMS=cpu python3 tools/port_registration_parity.py   # a few minutes

Three cases, one JSON line each, with both packages' registration quality
(inverse-consistency error, fold fractions) and seconds:

  * "network": the shipped width-24 GradICON on the 160x384x384 knee
    (percentile-windowed, as `KneePipeline.run` does) against its atlas;
  * "network_finetune20": the same plus 20 fine-tuning steps (the CLI's
    default registration, chip_smoke.py configuration (a));
  * "instance_small": `register_pair_instance` with the default schedule
    (scales 4, 2, 1; 80, 60, 40 steps) on the 48x96x96 small knee (scaled
    to [0, 1]) and its atlas.
"""

from __future__ import annotations

import json
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from oai_analysis_2_tpu.core.image import image_from_array as jimage  # noqa: E402
from oai_analysis_2_tpu.engine import registration as JR  # noqa: E402
from oai_analysis_2_tpu.models import gradicon as JG  # noqa: E402
from oai_analysis_2_tpu.ops.intensity import percentile_window as jwindow  # noqa: E402
from oai_analysis_2_tpu_torch.core.image import image_from_array as timage  # noqa: E402
from oai_analysis_2_tpu_torch.engine import registration as TR  # noqa: E402
from oai_analysis_2_tpu_torch.models import gradicon as TG  # noqa: E402
from oai_analysis_2_tpu_torch.ops.intensity import percentile_window as twindow  # noqa: E402

SPACING = (0.36, 0.36, 0.7)


def _floats(q):
    return {k: round(float(v), 6) for k, v in q.items()}


def main() -> int:
    torch.set_num_threads(4)
    warnings.simplefilter("ignore")
    knee, atlas = chip_smoke.knee_and_atlas(**chip_smoke.FULL)
    for name, kw in (("network", {}), ("network_finetune20", {"finetune_steps": 20})):
        t0 = time.perf_counter()
        jreg = JR.ICON_Registration(mode="network", **kw)
        jreg.register(jwindow(jimage(knee, spacing=SPACING), 0.1, 99.9, 0.0, 1.0), jimage(atlas, spacing=SPACING))
        t1 = time.perf_counter()
        treg = TR.ICON_Registration(mode="network", device="cpu", **kw)
        treg.register(twindow(timage(knee, spacing=SPACING, device="cpu"), 0.1, 99.9, 0.0, 1.0),
                      timage(atlas, spacing=SPACING, device="cpu"))
        t2 = time.perf_counter()
        print(json.dumps({"case": name, "jax": jreg.last_quality, "port": treg.last_quality,
                          "jax_s": t1 - t0, "port_s": t2 - t1}), flush=True)

    small_knee, small_atlas = chip_smoke.knee_and_atlas(**chip_smoke.SMALL)
    small_knee = small_knee / small_knee.max()
    sched = dict(scales=(4, 2, 1), steps_per_scale=(80, 60, 40))
    t0 = time.perf_counter()
    jab, jba = JG.register_pair_instance(jnp.asarray(small_knee), jnp.asarray(small_atlas), **sched)
    t1 = time.perf_counter()
    tab, tba = TG.register_pair_instance(torch.tensor(small_knee), torch.tensor(small_atlas), **sched)
    t2 = time.perf_counter()
    print(json.dumps({"case": "instance_small", "jax": _floats(JG.map_quality_stats(jab, jba)),
                      "port": _floats(TG.map_quality_stats(tab, tba)), "jax_s": t1 - t0, "port_s": t2 - t1}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
