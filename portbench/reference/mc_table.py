"""Programmatic 256-case marching-cubes triangle table, frozen here for the
plain reference (a copy of the port's `mesh/mc_table.py`).

The table is DERIVED at import from the Kuhn 6-tet case table by
collapsing the tetrahedra-only vertices (body and face diagonals) with a
fan over each removed vertex's link polygon; adjacent cubes triangulate
their shared face identically, so the surface is watertight. Winding:
normals (right-hand rule) point toward higher field values ("ascent").
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# -- Kuhn decomposition: 6 tetrahedra per cube, all sharing diagonal (0, 7).
# Corner index = x + 2y + 4z over the unit cube.
_CORNER_OFFSETS = np.array([[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)])

_TETS = np.array(
    [
        [0, 1, 3, 7],  # path x, y, z
        [0, 1, 5, 7],  # x, z, y
        [0, 2, 3, 7],  # y, x, z
        [0, 2, 6, 7],  # y, z, x
        [0, 4, 5, 7],  # z, x, y
        [0, 4, 6, 7],  # z, y, x
    ],
    np.int64,
)

# The 6 edges of a tetrahedron as (local vertex, local vertex).
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64
)


def _build_case_table() -> Tuple[np.ndarray, np.ndarray]:
    """For each of 16 inside-masks over tet vertices, up to 2 triangles, each
    triangle = 3 tet-edge indices. Orientation: normal toward the inside
    (higher-value) vertices, fixed numerically on a canonical tet."""
    # canonical positively-oriented tet
    pos = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])

    def edge_index(a, b):
        for ei, (u, v) in enumerate(_TET_EDGES):
            if {a, b} == {u, v}:
                return ei
        raise AssertionError

    tris_table = -np.ones((16, 2, 3), np.int64)
    for case in range(1, 15):
        inside = [v for v in range(4) if case >> v & 1]
        outside = [v for v in range(4) if not case >> v & 1]
        tris = []
        if len(inside) == 1:
            a = inside[0]
            tris.append([edge_index(a, b) for b in outside])
        elif len(inside) == 3:
            a = outside[0]
            tris.append([edge_index(a, b) for b in inside])
        else:  # 2 in / 2 out -> quad across 4 cut edges
            a, b = inside
            c, d = outside
            quad = [edge_index(a, c), edge_index(a, d), edge_index(b, d), edge_index(b, c)]
            tris.append([quad[0], quad[1], quad[2]])
            tris.append([quad[0], quad[2], quad[3]])
        # numeric orientation fix: midpoints of cut edges, normal toward inside
        inside_center = pos[inside].mean(axis=0)
        for t in tris:
            mids = np.array([(pos[_TET_EDGES[e][0]] + pos[_TET_EDGES[e][1]]) / 2 for e in t])
            n = np.cross(mids[1] - mids[0], mids[2] - mids[0])
            if np.dot(n, inside_center - mids.mean(axis=0)) < 0:
                t[1], t[2] = t[2], t[1]
        for ti, t in enumerate(tris):
            tris_table[case, ti] = t

    counts = np.zeros(16, np.int64)
    for case in range(16):
        counts[case] = int((tris_table[case, :, 0] >= 0).sum())
    return tris_table, counts


_TRIS_TABLE, _TRI_COUNTS = _build_case_table()

# chirality of each Kuhn tet (winding flip for negatively-oriented tets)
_TET_PARITY = np.array(
    [
        int(np.sign(np.linalg.det(
            (_CORNER_OFFSETS[_TETS[t, 1:]] - _CORNER_OFFSETS[_TETS[t, 0]]).astype(float)
        )))
        for t in range(6)
    ],
    np.int64,
)

# Cube-edge numbering: axis-major, (corner_a, corner_b) with corner index
# c = x + 2y + 4z (marching.py convention). Edge id = 4*axis + k.
EDGE_CORNERS = np.array(
    [
        # x-edges (bit 0)
        [0, 1], [2, 3], [4, 5], [6, 7],
        # y-edges (bit 1)
        [0, 2], [1, 3], [4, 6], [5, 7],
        # z-edges (bit 2)
        [0, 4], [1, 5], [2, 6], [3, 7],
    ],
    np.int64,
)

_PAIR_TO_EDGE: Dict[frozenset, int] = {
    frozenset(map(int, pair)): ei for ei, pair in enumerate(EDGE_CORNERS)
}


def _fan_triangulate(link: List[frozenset], closed: bool) -> List[Tuple[frozenset, ...]]:
    """Re-triangulate the region around a removed vertex from its link
    polygon. Orientation is inherited: link order follows the winding of the
    removed fan."""
    pts = list(link)
    if closed:
        if len(pts) < 3:
            return []
        return [(pts[0], pts[i], pts[i + 1]) for i in range(1, len(pts) - 1)]
    if len(pts) < 3:
        return []  # the fan collapses to the closing chord
    return [(pts[0], pts[i], pts[i + 1]) for i in range(1, len(pts) - 1)]


def _remove_vertex(tris: List[tuple], v: frozenset) -> List[tuple]:
    """Remove vertex label `v` from a combinatorial triangulation by link
    re-triangulation. The link may have several components (handled
    independently)."""
    keep, fan = [], []
    for t in tris:
        (fan if v in t else keep).append(t)
    if not fan:
        return tris
    # directed link edges: rotate each triangle so v is first -> (p, q)
    succ: Dict[frozenset, frozenset] = {}
    nodes = set()
    for t in fan:
        i = t.index(v)
        p, q = t[(i + 1) % 3], t[(i + 2) % 3]
        if p == q:  # degenerate sliver around v
            continue
        succ[p] = q
        nodes.add(p)
        nodes.add(q)
    # split into components: open paths start at nodes with no predecessor
    preds = set(succ.values())
    starts = [n for n in nodes if n in succ and n not in preds]
    visited = set()
    for start in starts:  # open paths (boundary vertex on a cube face)
        path = [start]
        visited.add(start)
        cur = start
        while cur in succ and succ[cur] not in visited:
            cur = succ[cur]
            path.append(cur)
            visited.add(cur)
        keep.extend(_fan_triangulate(path, closed=False))
    for n in list(nodes):  # remaining components are closed cycles
        if n in visited or n not in succ:
            continue
        cycle = [n]
        visited.add(n)
        cur = succ[n]
        while cur != n:
            cycle.append(cur)
            visited.add(cur)
            cur = succ[cur]
        keep.extend(_fan_triangulate(cycle, closed=True))
    return keep


def _tet_surface_tris(code: int) -> List[tuple]:
    """Combinatorial marching-tet triangulation of one cube code: triangles
    as label triples, label = frozenset{corner_a, corner_b} of the cut
    segment, winding identical to marching.py's numeric path."""
    tris: List[tuple] = []
    for t in range(6):
        corners = _TETS[t]
        case = 0
        for v in range(4):
            if code >> int(corners[v]) & 1:
                case |= 1 << v
        for k in range(2):
            edges = _TRIS_TABLE[case, k]
            if edges[0] < 0:
                continue
            e0, e1, e2 = (int(e) for e in edges)
            if _TET_PARITY[t] < 0:
                e1, e2 = e2, e1
            tri = []
            for e in (e0, e1, e2):
                a, b = _TET_EDGES[e]
                tri.append(frozenset({int(corners[a]), int(corners[b])}))
            tris.append(tuple(tri))
    return tris


def _build_mc_table() -> Tuple[np.ndarray, np.ndarray]:
    max_tris = 0
    per_code: List[List[Tuple[int, int, int]]] = []
    for code in range(256):
        tris = _tet_surface_tris(code)
        # remove the body-diagonal vertex first (interior: closed link),
        # then the six 0/7 face diagonals (boundary: open links)
        diag_labels = [frozenset({0, 7})] + [
            lab
            for t in tris
            for lab in t
            if lab not in _PAIR_TO_EDGE and lab != frozenset({0, 7})
        ]
        seen = set()
        for lab in diag_labels:
            if lab in seen:
                continue
            seen.add(lab)
            tris = _remove_vertex(tris, lab)
        out = []
        for t in tris:
            assert all(lab in _PAIR_TO_EDGE for lab in t), (code, t)
            ids = tuple(_PAIR_TO_EDGE[lab] for lab in t)
            if len(set(ids)) == 3:
                out.append(ids)
        per_code.append(out)
        max_tris = max(max_tris, len(out))

    table = -np.ones((256, max_tris, 3), np.int8)
    counts = np.zeros(256, np.int32)
    for code, tris in enumerate(per_code):
        counts[code] = len(tris)
        for ti, t in enumerate(tris):
            table[code, ti] = t
    return table, counts


MC_TRI_TABLE, MC_TRI_COUNT = _build_mc_table()
MC_MAX_TRIS = MC_TRI_TABLE.shape[1]
