"""Marching cubes on the card (port of the device path of
`oai_analysis_2_tpu/mesh/marching_cubes.py:113-224`).

Input: a 3D tensor indexed [x, y, z]; output: a host `Mesh` with
spacing-scaled xyz vertex coordinates on cube edges and ascent-oriented
triangles from the 256-case table (mesh/mc_table.py).

Vertex dedup is direct-addressed: a vertex exists iff a grid edge changes
sign, so vertex ids are exclusive-cumsum ranks over the flattened
crossing-edge masks (x-edges, then y, then z) and face indices are gathers
of those ranks; faces come in active-cube order. That is the JAX device
path's order exactly. Its bounding-box slicing (:237-277), a TPU
data-movement saving, is left out: vertex coordinates then differ from it
only by float32 rounding.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from oai_analysis_2_tpu_torch.mesh.mc_table import _CORNER_OFFSETS, MC_MAX_TRIS, MC_TRI_TABLE
from oai_analysis_2_tpu_torch.mesh.types import Mesh

# Per cube-edge id: the in-cube offset of the edge's base lattice point.
# x-edges: (0, k&1, k>>1); y-edges: (k&1, 0, k>>1); z-edges: (k&1, k>>1, 0).
_EDGE_BASE_OFFSET = np.zeros((12, 3), np.int64)
for _e in range(12):
    _axis, _k = _e // 4, _e % 4
    _others = [a for a in range(3) if a != _axis]
    _EDGE_BASE_OFFSET[_e, _others[0]] = _k & 1
    _EDGE_BASE_OFFSET[_e, _others[1]] = _k >> 1


def _empty() -> Mesh:
    return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))


def _codes(inside: torch.Tensor) -> torch.Tensor:
    nx, ny, nz = inside.shape
    c = torch.zeros((nx - 1, ny - 1, nz - 1), dtype=torch.uint8, device=inside.device)
    for ci in range(8):
        ox, oy, oz = (int(o) for o in _CORNER_OFFSETS[ci])
        c |= inside[ox : nx - 1 + ox, oy : ny - 1 + oy, oz : nz - 1 + oz].to(torch.uint8) << ci
    return c


def _extract(vol: torch.Tensor, level: float, spacing) -> Mesh:
    dev = vol.device
    nx, ny, nz = vol.shape
    inside = vol > level
    cross = [
        (inside[:-1, :, :] != inside[1:, :, :]).reshape(-1),
        (inside[:, :-1, :] != inside[:, 1:, :]).reshape(-1),
        (inside[:, :, :-1] != inside[:, :, 1:]).reshape(-1),
    ]
    offs = torch.as_tensor([0, cross[0].numel(), cross[0].numel() + cross[1].numel()], device=dev)
    mask_all = torch.cat(cross)
    rank_all = torch.cumsum(mask_all, 0) - mask_all.to(torch.int64)

    # vertices: compact the crossing edges, interpolate along each
    vidx = torch.nonzero(mask_all).squeeze(1)
    axis = (vidx >= offs[1]).to(torch.int64) + (vidx >= offs[2]).to(torch.int64)
    local = vidx - offs[axis]
    shapes = torch.as_tensor([[nx - 1, ny, nz], [nx, ny - 1, nz], [nx, ny, nz - 1]], device=dev)
    sh = shapes[axis]
    plane = sh[:, 1] * sh[:, 2]
    rem = local % plane
    p0 = torch.stack([local // plane, rem // sh[:, 2], rem % sh[:, 2]], dim=-1)
    p1 = p0 + (torch.arange(3, device=dev)[None, :] == axis[:, None]).to(p0.dtype)
    flat = vol.reshape(-1)
    va = flat[(p0[:, 0] * ny + p0[:, 1]) * nz + p0[:, 2]]
    vb = flat[(p1[:, 0] * ny + p1[:, 1]) * nz + p1[:, 2]]
    denom = vb - va
    lvl = torch.as_tensor(level, dtype=torch.float32, device=dev)
    tv = torch.clamp(
        torch.where(torch.abs(denom) > 1e-20,
                    (lvl - va) / torch.where(denom == 0, torch.ones_like(denom), denom),
                    torch.full_like(denom, 0.5)),
        0.0, 1.0,
    )
    sp = torch.as_tensor(np.asarray(spacing, np.float32), device=dev)
    verts = (p0.to(torch.float32) + tv[:, None] * (p1 - p0).to(torch.float32)) * sp[None, :]

    # faces: compact active cubes, then their valid triangle slots
    codes = _codes(inside)
    active = ((codes > 0) & (codes < 255)).reshape(-1)
    cube_idx = torch.nonzero(active).squeeze(1)
    if cube_idx.numel() == 0:
        return _empty()
    tri_table = torch.as_tensor(MC_TRI_TABLE.astype(np.int64), device=dev)
    tris = tri_table[codes.reshape(-1)[cube_idx].to(torch.int64)]  # (M, MAXT, 3)
    slot_valid = (tris[..., 0] >= 0).reshape(-1)
    tslot = torch.nonzero(slot_valid).squeeze(1)
    tcube = cube_idx[tslot // MC_MAX_TRIS]
    tedges = tris.reshape(-1, 3)[tslot]
    ncy, ncz = ny - 1, nz - 1
    cpos = torch.stack([tcube // (ncy * ncz), (tcube // ncz) % ncy, tcube % ncz], dim=-1)
    edge_base = torch.as_tensor(_EDGE_BASE_OFFSET, device=dev)
    eaxis = tedges // 4
    ebase = cpos[:, None, :] + edge_base[tedges]
    esh = shapes[eaxis]
    elin = (ebase[..., 0] * esh[..., 1] + ebase[..., 1]) * esh[..., 2] + ebase[..., 2]
    faces = rank_all[elin + offs[eaxis]]
    return Mesh(verts.cpu().numpy(), faces.cpu().numpy().astype(np.int32))


def marching_cubes(volume: torch.Tensor, level: float = 0.5,
                   spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> Mesh:
    """The `level` iso-surface of a 3D tensor indexed [x, y, z], computed on
    the tensor's device."""
    if min(volume.shape) < 2:
        return _empty()
    return _extract(volume.to(torch.float32), level, spacing)


def marching_cubes_multi(volumes, level: float = 0.5, spacing=(1.0, 1.0, 1.0), devices=None):
    """Iso-surfaces of several volumes; `devices` (optional, one per volume)
    moves each volume to its device first. A device list of another length
    than the volume list raises (the JAX version's zip truncates)."""
    volumes = list(volumes)
    if devices is not None:
        devices = list(devices)
        if len(devices) != len(volumes):
            raise ValueError(f"{len(volumes)} volumes but {len(devices)} devices")
        volumes = [v.to(d) for v, d in zip(volumes, devices)]
    return [marching_cubes(v, level, spacing) for v in volumes]
