"""Where the knee batch's smoothing time goes, on the card: the host's
adjacency and neighbour table against the 150-iteration loop, for B knees'
FC + TC meshes smoothed as one union and as one union per knee, with the
table built three ways: `native` (the host-geometry library's CSR and
fill, what `smooth_mesh` runs), `numpy` (the plain `_adjacency` with its
1-D edge key and `_neighbor_table`) and `numpy_2d` (the port's adjacency
before the 1-D key: a 2-D `np.unique` of edge rows). The component
filter's labels are timed too (`native` union-find against scipy).

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
from oai_analysis_2_tpu_torch import native  # noqa: E402
from oai_analysis_2_tpu_torch.mesh.components import (  # noqa: E402
    _union_find_labels,
    filter_small_components,
    scipy_component_labels,
)
from oai_analysis_2_tpu_torch.mesh.marching_cubes import marching_cubes  # noqa: E402
from oai_analysis_2_tpu_torch.mesh.ops import (  # noqa: E402
    _adjacency,
    _csr_adjacency,
    _neighbor_table,
    _smooth_loop,
    _table_from_csr,
    _table_width,
)
from oai_analysis_2_tpu_torch.mesh.processing import _as_xyz, _spacing  # noqa: E402
from oai_analysis_2_tpu_torch.mesh.types import Mesh  # noqa: E402


def union(meshes) -> Mesh:
    offsets = np.cumsum([0] + [m.n_points for m in meshes])
    return Mesh(np.concatenate([m.vertices for m in meshes]),
                np.concatenate([m.faces + offsets[i] for i, m in enumerate(meshes)]).astype(np.int32))


def adjacency_2d(mesh: Mesh):
    """The port's `_adjacency` before the 1-D edge key: a 2-D `np.unique`
    of sorted edge rows (the same edge list)."""
    f = mesh.faces.astype(np.int64)
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    uniq, counts = np.unique(np.sort(edges, axis=1), axis=0, return_counts=True)
    boundary_edges = uniq[counts == 1]
    is_boundary = np.zeros(mesh.n_points, bool)
    is_boundary[np.unique(boundary_edges)] = True
    src = np.concatenate([uniq[:, 0], uniq[:, 1]])
    dst = np.concatenate([uniq[:, 1], uniq[:, 0]])
    b_src = np.concatenate([boundary_edges[:, 0], boundary_edges[:, 1]])
    b_dst = np.concatenate([boundary_edges[:, 1], boundary_edges[:, 0]])
    interior = ~is_boundary[src]
    return np.concatenate([src[interior], b_src]).astype(np.int32), np.concatenate([dst[interior], b_dst]).astype(
        np.int32)


def split_times(mesh: Mesh, path: str, device="cuda", iterations: int = 150) -> dict:
    """`smooth_mesh`'s steps on `device` with the table built by `path`,
    each timed to its end."""
    nv = mesh.n_points + 1
    t0 = time.perf_counter()
    if path == "native":
        deg, nbr = _csr_adjacency(mesh)
        t1 = time.perf_counter()
        tbl = _table_from_csr(deg, nbr, nv, _table_width(deg.max()), nv - 1)
    else:
        src, dst = _adjacency(mesh)[:2] if path == "numpy" else adjacency_2d(mesh)
        t1 = time.perf_counter()
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
    native.build()
    runs = {f"{grouping}:{path}": [] for path in ("native", "numpy", "numpy_2d")
            for grouping in ("one_union", "union_per_knee")}
    labels = {"native": [], "scipy": []}
    whole = union(tissues)
    for _ in range(args.repeats):
        for path in ("native", "numpy", "numpy_2d"):
            runs[f"one_union:{path}"].append(split_times(whole, path))
            per = [split_times(union(tissues[i : i + 2]), path) for i in range(0, len(tissues), 2)]
            runs[f"union_per_knee:{path}"].append({k: sum(p[k] for p in per) for k in per[0]})
        for name, fn in (("native", _union_find_labels), ("scipy", scipy_component_labels)):
            t0 = time.perf_counter()
            fn(whole.n_points, whole.faces)
            labels[name].append(time.perf_counter() - t0)
    out = {
        "knees": args.knees, "tissue_points": [m.n_points for m in raws], "tissue_faces": [m.n_cells for m in raws],
        "seconds_median": {name: {k: statistics.median(r[k] for r in rs) for k in rs[0]} for name, rs in runs.items()},
        "component_labels_of_the_union_s_median": {k: statistics.median(v) for k, v in labels.items()},
        "card": bench.card_line(),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
