"""Marching tetrahedra on the card (port of the device path of
`oai_analysis_2_tpu/mesh/marching.py:292-451`: occupancy codes as in
`_cube_codes_device`, :141, emission and vertex dedup as in `_emit_device`,
:163-278).

Input: a 3D tensor indexed [x, y, z]; output: a host `Mesh` with
spacing-scaled xyz vertices on tetrahedron edges and triangles whose normals
(right-hand rule) point toward higher values ("ascent"). Each cube splits
into the six Kuhn tetrahedra around its (0, 7) diagonal, with the case
table of `mesh/mc_table.py`, so the surface is watertight.

Every step runs on the tensor's device: the codes, the active cubes, the
corner gather, the per-tetrahedron cases, and the dedup of edge vertices
by their (lo, hi) corner-id key, whose sorted order is the vertex order of
both JAX paths. Each vertex is interpolated from its edge's lower corner
id to its higher one, so every occurrence of an edge gives the same point.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from oai_analysis_2_tpu_torch.mesh.marching_cubes import _codes, _empty
from oai_analysis_2_tpu_torch.mesh.mc_table import (
    _CORNER_OFFSETS,
    _TET_EDGES,
    _TET_PARITY,
    _TETS,
    _TRIS_TABLE,
)
from oai_analysis_2_tpu_torch.mesh.types import Mesh


def marching_tetrahedra(volume: torch.Tensor, level: float = 0.5,
                        spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> Mesh:
    """The `level` iso-surface of a 3D tensor indexed [x, y, z], computed on
    the tensor's device."""
    if min(volume.shape) < 2:
        return _empty()
    vol = volume.to(torch.float32)
    dev = vol.device
    nx, ny, nz = vol.shape
    codes = _codes(vol > level)
    cube = torch.nonzero(((codes > 0) & (codes < 255)).reshape(-1)).squeeze(1)
    if cube.numel() == 0:
        return _empty()

    def table(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    ncy, ncz = ny - 1, nz - 1
    cpos = torch.stack([cube // (ncy * ncz), (cube // ncz) % ncy, cube % ncz], dim=-1)
    corner = cpos[:, None, :] + table(_CORNER_OFFSETS)[None]  # (M, 8, 3)
    ids = (corner[..., 0] * ny + corner[..., 1]) * nz + corner[..., 2]  # (M, 8)
    vals = vol.reshape(-1)[ids]

    tets = table(_TETS)
    vals_t, ids_t = vals[:, tets], ids[:, tets]  # (M, 6, 4)
    case = ((vals_t > level).to(torch.int64) << torch.arange(4, device=dev)).sum(-1)  # (M, 6)
    tri_edges = table(_TRIS_TABLE)[case]  # (M, 6, 2, 3), -1 where no triangle
    m, t, k = torch.nonzero(tri_edges[..., 0] >= 0, as_tuple=True)
    edges = tri_edges[m, t, k]  # (T, 3) tet-edge indices, in (cube, tet, slot) order
    flip = (table(_TET_PARITY)[t] < 0)[:, None]  # mirrored tets wind the other way
    edges = torch.where(flip, edges[:, [0, 2, 1]], edges)

    ev = table(_TET_EDGES)[edges]  # (T, 3, 2) local tet-vertex pairs
    tet_ids, tet_vals = ids_t[m, t], vals_t[m, t]  # (T, 4)
    ga = torch.gather(tet_ids, 1, ev[..., 0])
    gb = torch.gather(tet_ids, 1, ev[..., 1])
    va = torch.gather(tet_vals, 1, ev[..., 0])
    vb = torch.gather(tet_vals, 1, ev[..., 1])
    a_low = ga <= gb
    lo, hi = torch.where(a_low, ga, gb), torch.where(a_low, gb, ga)
    v_lo, v_hi = torch.where(a_low, va, vb), torch.where(a_low, vb, va)

    keys = (lo * (nx * ny * nz) + hi).reshape(-1)
    uniq, inv = torch.unique(keys, return_inverse=True)
    faces = inv.reshape(-1, 3)
    # any occurrence of an edge stands for it: all of them carry the same
    # corners and values
    rep = torch.empty(len(uniq), dtype=torch.int64, device=dev)
    rep.scatter_(0, inv, torch.arange(keys.numel(), device=dev))
    lo_u, hi_u = lo.reshape(-1)[rep], hi.reshape(-1)[rep]
    va_u, vb_u = v_lo.reshape(-1)[rep], v_hi.reshape(-1)[rep]
    denom = vb_u - va_u
    tv = torch.clamp(
        torch.where(torch.abs(denom) > 1e-20,
                    (level - va_u) / torch.where(denom == 0, torch.ones_like(denom), denom),
                    torch.full_like(denom, 0.5)),
        0.0, 1.0,
    )

    def decode(g):
        rem = g % (ny * nz)
        return torch.stack([g // (ny * nz), rem // nz, rem % nz], dim=-1).to(torch.float32)

    pa, pb = decode(lo_u), decode(hi_u)
    sp = torch.as_tensor(np.asarray(spacing, np.float32), device=dev)
    verts = (pa + tv[:, None] * (pb - pa)) * sp[None, :]
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return Mesh(verts.cpu().numpy(), faces[good].cpu().numpy().astype(np.int32))
