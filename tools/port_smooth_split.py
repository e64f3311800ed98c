"""Where the knee batch's smoothing time goes, on the card: the host's
adjacency and neighbour table against the 150-iteration loop, for B knees'
FC + TC meshes smoothed as one union and as one union per knee.

    python3 tools/port_smooth_split.py [--knees 8] [--repeats 3]

The meshes are the bench knee's (`oai_analysis_2_tpu_torch.bench`): one
`KneePipeline.run` gives the warped FC and TC maps, whose iso-surfaces
with small components removed are what `get_thickness_meshes` smooths;
B copies stand in for B knees. Prints one JSON object: the median seconds
of each part over the repeats, the mesh sizes and the card line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from oai_analysis_2_tpu_torch import bench  # noqa: E402
from oai_analysis_2_tpu_torch.mesh.components import filter_small_components  # noqa: E402
from oai_analysis_2_tpu_torch.mesh.marching_cubes import marching_cubes  # noqa: E402
from oai_analysis_2_tpu_torch.mesh.ops import _adjacency, _neighbor_table, _smooth_loop  # noqa: E402
from oai_analysis_2_tpu_torch.mesh.processing import _as_xyz, _spacing  # noqa: E402
from oai_analysis_2_tpu_torch.mesh.types import Mesh  # noqa: E402


def union(meshes) -> Mesh:
    offsets = np.cumsum([0] + [m.n_points for m in meshes])
    return Mesh(np.concatenate([m.vertices for m in meshes]),
                np.concatenate([m.faces + offsets[i] for i, m in enumerate(meshes)]).astype(np.int32))


def split_times(mesh: Mesh, device="cuda", iterations: int = 150) -> dict:
    """`smooth_mesh`'s steps on `device`, each timed to its end."""
    t0 = time.perf_counter()
    src, dst, _ = _adjacency(mesh)
    t1 = time.perf_counter()
    nv = mesh.n_points + 1
    tbl = _neighbor_table(src, dst, nv, nv - 1)
    t2 = time.perf_counter()
    vp = np.zeros((nv, 3), np.float32)
    vp[: mesh.n_points] = mesh.vertices
    out = _smooth_loop(torch.as_tensor(vp, device=device), torch.as_tensor(tbl, device=device), iterations, 0.01)
    out.cpu()
    t3 = time.perf_counter()
    return {"adjacency": t1 - t0, "table": t2 - t1, "loop_and_copies": t3 - t2, "total": t3 - t0}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--knees", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    pipe, knee = bench.build_pipeline()
    res = pipe.run(knee)
    raws = [filter_small_components(marching_cubes(_as_xyz(m), 0.5, _spacing(m)), 3000)
            for m in (res.fc_probmap, res.tc_probmap)]
    tissues = raws * args.knees
    runs = {"one_union": [], "union_per_knee": []}
    for _ in range(args.repeats):
        runs["one_union"].append(split_times(union(tissues)))
        per = [split_times(union(tissues[i : i + 2])) for i in range(0, len(tissues), 2)]
        runs["union_per_knee"].append({k: sum(p[k] for p in per) for k in per[0]})
    out = {
        "knees": args.knees, "tissue_points": [m.n_points for m in raws], "tissue_faces": [m.n_cells for m in raws],
        "seconds_median": {name: {k: statistics.median(r[k] for r in rs) for k in rs[0]} for name, rs in runs.items()},
        "card": bench.card_line(),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
