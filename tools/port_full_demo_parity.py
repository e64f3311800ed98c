"""How far the port's phantom full demo lies from the JAX package's, on the
CPU: the unchanged `examples/full_demo.py phantom` and the port's
`oai_analysis_2_tpu_torch.examples.full_demo.main(["phantom", dir],
device="cpu")`, each in its own process at one `OAI_DEMO_SHAPE`.

    JAX_PLATFORMS=cpu python tools/port_full_demo_parity.py [--shape 80,192,192] [--port-only]

Both write into the git-ignored `build/full_demo_parity/`. Prints each
run's printed numbers (FC / TC inner mesh points and mean thickness, raster
coverage and mean mapped thickness), its wall seconds or its error's last
lines, then one JSON object with the gaps (port minus JAX; relative for
the mesh sizes and the means). `--port-only` skips the JAX run (for a
size where it is known to fail). At 80x192x192 each run takes minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "full_demo_parity"

# the port's module on the CPU: its main takes the device as an argument
PORT = ("import sys; from oai_analysis_2_tpu_torch.examples import full_demo; "
        "full_demo.main(sys.argv[1:], device='cpu')")

LINE = {
    "mesh": re.compile(r"^(FC|TC) mesh: (\d+) pts, mean thickness ([-\d.naninf]+)$"),
    "raster": re.compile(r"^(FC|TC) 2D atlas raster: coverage ([-\d.naninf]+)%, mean thickness ([-\d.naninf]+) mm$"),
}


def parse(out: str) -> dict:
    """The demo's printed numbers: {fc,tc}_{points, mean_thickness,
    coverage, mapped_mean_mm}."""
    got = {}
    for line in out.splitlines():
        m = LINE["mesh"].match(line.strip())
        if m:
            t = m.group(1).lower()
            got[f"{t}_points"] = int(m.group(2))
            got[f"{t}_mean_thickness"] = float(m.group(3))
        m = LINE["raster"].match(line.strip())
        if m:
            t = m.group(1).lower()
            got[f"{t}_coverage"] = float(m.group(2)) / 100.0
            got[f"{t}_mapped_mean_mm"] = float(m.group(3))
    return got


def run(name: str, cmd, shape: str) -> dict:
    env = dict(os.environ, OAI_DEMO_SHAPE=shape, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    report = {"wall_s": wall, "rc": proc.returncode, **parse(proc.stdout)}
    if proc.returncode != 0:
        report["error"] = proc.stderr.strip().splitlines()[-3:]
    print(f"{name}: {json.dumps(report)}", flush=True)
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="80,192,192")
    ap.add_argument("--port-only", action="store_true")
    args = ap.parse_args()
    tag = args.shape.replace(",", "x")
    runs = {}
    if not args.port_only:
        runs["jax"] = run("jax", [sys.executable, "examples/full_demo.py", "phantom", str(OUT / f"jax_{tag}")],
                          args.shape)
    runs["port"] = run("port", [sys.executable, "-c", PORT, "phantom", str(OUT / f"port_{tag}")], args.shape)
    gaps = {}
    if "jax" in runs and runs["jax"]["rc"] == 0 and runs["port"]["rc"] == 0:
        j, p = runs["jax"], runs["port"]
        for t in ("fc", "tc"):
            gaps[f"{t}_points_rel"] = (p[f"{t}_points"] - j[f"{t}_points"]) / j[f"{t}_points"]
            gaps[f"{t}_mean_thickness_rel"] = (p[f"{t}_mean_thickness"] - j[f"{t}_mean_thickness"]) / j[
                f"{t}_mean_thickness"]
            gaps[f"{t}_coverage_abs"] = p[f"{t}_coverage"] - j[f"{t}_coverage"]
            gaps[f"{t}_mapped_mean_rel"] = (p[f"{t}_mapped_mean_mm"] - j[f"{t}_mapped_mean_mm"]) / j[
                f"{t}_mapped_mean_mm"]
    print(json.dumps({"shape": args.shape, "runs": runs, "gaps": gaps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
