"""How far the port's smoothed meshes lie from the JAX package's, with the
port's neighbour table in the host-geometry library's order (each vertex's
neighbours ascending, the JAX package's order, what `smooth_mesh` runs)
and in the plain edge list's order (the port's table before it took the
library's: a vertex's greater neighbours, then its lesser ones).

    JAX_PLATFORMS=cpu python tools/port_smooth_parity.py   # on the CPU, both packages

The meshes: the bench fixture's FC and TC shells at 48x96x96 (as
`tests/test_torch_mesh.py` builds them) and at 96x192x192, through the JAX
package's marching cubes and component filter; both packages smooth the
same filtered meshes (150 iterations, one union per size), and split them
into inner and outer faces. Prints one JSON object: per size and order,
the largest and mean vertex-coordinate gap in mm, the share of
coordinates that are bit-equal, and the faces whose side of the split
differs from the JAX package's.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from oai_analysis_2_tpu.core.image import image_from_array as jimage  # noqa: E402
from oai_analysis_2_tpu.mesh import split as JS  # noqa: E402
from oai_analysis_2_tpu.mesh.components import filter_small_components as jfilter  # noqa: E402
from oai_analysis_2_tpu.mesh.marching_cubes import marching_cubes_multi as jmc  # noqa: E402
from oai_analysis_2_tpu.mesh.ops import smooth_meshes as jsmooth  # noqa: E402
from oai_analysis_2_tpu.mesh.processing import _as_xyz as jxyz  # noqa: E402
from oai_analysis_2_tpu_torch.bench import shell_probmap  # noqa: E402
from oai_analysis_2_tpu_torch.mesh import split as TS  # noqa: E402
from oai_analysis_2_tpu_torch.mesh.ops import _adjacency, _neighbor_table, _smooth_loop, smooth_meshes  # noqa: E402
from oai_analysis_2_tpu_torch.mesh.types import Mesh  # noqa: E402

SPACING = (0.36, 0.36, 0.7)


def shells(scale: int):
    """The bench fixture's FC and TC shells at (48, 96, 96) x scale."""
    shape = (48 * scale, 96 * scale, 96 * scale)
    return shape, {"FC": shell_probmap(shape, 27.5 * scale, 31.5 * scale, (24 * scale, 53 * scale, 48 * scale)),
                   "TC": shell_probmap(shape, 15.5 * scale, 19.5 * scale, (24 * scale, 60 * scale, 48 * scale))}


def smooth_edge_list_order(meshes, iterations=150):
    """The port's smoothing before the library's table: the union's table
    from the plain edge list in its own order."""
    offsets = np.cumsum([0] + [m.n_points for m in meshes])
    union = Mesh(np.concatenate([m.vertices for m in meshes]),
                 np.concatenate([m.faces + offsets[i] for i, m in enumerate(meshes)]).astype(np.int32))
    src, dst, _ = _adjacency(union)
    nv = union.n_points + 1
    tbl = _neighbor_table(src, dst, nv, nv - 1)
    vp = np.zeros((nv, 3), np.float32)
    vp[: union.n_points] = union.vertices
    out = _smooth_loop(torch.as_tensor(vp), torch.as_tensor(tbl), iterations, 0.01).numpy()
    res = []
    for i, m in enumerate(meshes):
        r = m.copy()
        r.vertices = out[offsets[i] : offsets[i + 1]]
        res.append(r)
    return res


def as_port(m) -> Mesh:
    return Mesh(np.asarray(m.vertices, np.float32), np.asarray(m.faces, np.int32))


def split_sides(meshes, kinds, split_fn):
    """Per tissue, each face's side (1 inner, 2 outer, 0 neither) in the
    input mesh's face order, matched by the faces' vertex triples."""
    out = []
    for mesh, (inner, outer) in zip(meshes, split_fn(meshes, kinds)):
        side = {}
        for label, part in ((1, inner), (2, outer)):
            tri = np.sort(np.asarray(part.vertices)[np.asarray(part.faces)].reshape(len(part.faces), -1), axis=1)
            for row in map(tuple, np.round(tri, 3)):
                side[row] = label
        tri = np.sort(np.asarray(mesh.vertices)[np.asarray(mesh.faces)].reshape(len(mesh.faces), -1), axis=1)
        out.append(np.array([side.get(row, 0) for row in map(tuple, np.round(tri, 3))]))
    return out


def main() -> None:
    torch.set_num_threads(4)
    report = {}
    for scale in (1, 2):
        shape, maps = shells(scale)
        kinds = list(maps)
        filtered = [jfilter(jmc([jxyz(jimage(maps[k], spacing=SPACING))], 0.5, SPACING)[0]) for k in kinds]
        want = jsmooth(filtered)
        want_sides = split_sides(want, kinds, JS.split_meshes)
        port_in = [as_port(m) for m in filtered]
        row = {"points": [int(m.n_points) for m in filtered]}
        for order, got in (("library_order", smooth_meshes(port_in, device="cpu")),
                           ("edge_list_order", smooth_edge_list_order(port_in))):
            gaps = np.concatenate([np.abs(g.vertices - np.asarray(w.vertices)).ravel() for g, w in zip(got, want)])
            sides = split_sides(got, kinds, TS.split_meshes)
            row[order] = {"max_vertex_gap_mm": float(gaps.max()), "mean_vertex_gap_mm": float(gaps.mean()),
                          "coordinates_bit_equal_share": float((gaps == 0).mean()),
                          "faces_on_another_side": [int((a != b).sum()) for a, b in zip(sides, want_sides)]}
        report["x".join(map(str, shape))] = row
    print(json.dumps(report))


if __name__ == "__main__":
    main()
