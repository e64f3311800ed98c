"""The port's percentiles against `jnp.percentile` over a sweep of sizes
and percentiles, on the CPU, in one process that imports both packages.

    JAX_PLATFORMS=cpu python tools/port_percentile_sweep.py

For each size (4,743 to 23,592,960 elements: the f32 interpolation
position rounds differently across it, and n - 1 itself rounds above
2^24) a seeded gamma array goes through `jnp.percentile` called on its own
and inside a jitted, vmapped program (as the JAX knee batch calls it),
and through the port's `ops.intensity._percentiles` with `folded` False
and True. Prints one JSON line a size with the cases that differ, then one
JSON object with the totals; exits non-zero if any case differs. About 4
minutes.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SIZES = (4743, 5000, 65537, 1_000_003, 2**21 + 17, 2_949_120, 2**22 + 5, 5_000_001, 2**24 + 3, 23_592_960)
PERCS = (0.1, 99.9, 0.0, 100.0, 37.5, 62.5)


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch

    from oai_analysis_2_tpu_torch.ops.intensity import _percentiles

    in_program = jax.jit(jax.vmap(lambda k: jnp.stack([jnp.percentile(k, p) for p in PERCS])))
    rng = np.random.default_rng(0)
    cases = bad = 0
    for n in SIZES:
        x = rng.gamma(2.0, 100.0, n).astype(np.float32)
        want = {False: [np.float32(jnp.percentile(jnp.asarray(x), p)) for p in PERCS],
                True: list(np.asarray(in_program(jnp.asarray(x)[None]))[0])}
        row = {"n": n, "differ": []}
        for folded in (False, True):
            got = np.float32(_percentiles(torch.from_numpy(x), PERCS, folded=folded))
            for p, g, w in zip(PERCS, got, want[folded]):
                cases += 1
                if g != w:
                    row["differ"].append({"p": p, "folded": folded, "port": float(g), "jax": float(w)})
        bad += len(row["differ"])
        print(json.dumps(row), flush=True)
    print(json.dumps({"cases": cases, "differ": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
