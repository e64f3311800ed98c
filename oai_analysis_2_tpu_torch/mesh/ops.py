"""Mesh geometry: normals, centroids, Laplacian smoothing, exact
point-to-surface distance (port of `oai_analysis_2_tpu/mesh/ops.py`).

Smoothing is the JAX package's neighbour-table loop (`_smooth_loop`,
:87-116) on the card: 150 iterations of one (N, K) row gather + sum. Its
degree-tiered table layout (:119-308), a TPU gather-volume saving that
gives the same sums, is left out. The distance goes through the
hand-written point-to-triangle kernel (ops/cuda_kernels.py).
"""

from __future__ import annotations

import numpy as np
import torch

from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.mesh.types import Mesh
from oai_analysis_2_tpu_torch.ops.cuda_kernels import point_triangle_distance


def face_centroids(mesh: Mesh) -> np.ndarray:
    """(F, 3) per-face centroid."""
    return mesh.triangles().mean(axis=1)


def face_normals(mesh: Mesh, normalized: bool = True) -> np.ndarray:
    """(F, 3) per-face normals by right-hand winding."""
    tri = mesh.triangles()
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    if normalized:
        n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    return n


def _adjacency(mesh: Mesh):
    """Symmetric edge list (src, dst) and per-vertex degree; boundary
    vertices average only over boundary neighbours (vtkSmoothPolyDataFilter's
    boundary rule). Numpy path of ops.py:54-84."""
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
    src = np.concatenate([src[interior], b_src])
    dst = np.concatenate([dst[interior], b_dst])
    deg = np.bincount(src, minlength=mesh.n_points).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), deg


def _neighbor_table(src: np.ndarray, dst: np.ndarray, nv: int, dummy: int):
    """(nv, K) neighbour table padded with `dummy` (ops.py:155-169); K is
    the max degree rounded up to a power of two, at least 8."""
    deg = np.bincount(src, minlength=nv)
    k = max(8, 1 << int(np.ceil(np.log2(max(int(deg.max()), 1))))) if len(src) else 8
    order = np.argsort(src, kind="stable")
    ssrc, sdst = src[order], dst[order]
    starts = np.zeros(nv, np.int64)
    np.cumsum(deg[:-1], out=starts[1:])
    col = np.arange(len(ssrc)) - starts[ssrc]
    tbl = np.full((nv, k), dummy, np.int64)
    tbl[ssrc, col] = sdst
    return tbl


def _smooth_loop(verts: torch.Tensor, nbr_table: torch.Tensor, num_iterations: int,
                 relaxation: float) -> torch.Tensor:
    """The last row of `verts` is an all-zero immovable dummy that padding
    table entries point at, so they add nothing; degrees come from the
    table."""
    dummy = verts.shape[0] - 1
    deg = torch.sum(nbr_table != dummy, dim=1).to(verts.dtype)
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0), torch.zeros_like(deg))[:, None]
    movable = (deg > 0)[:, None]
    relax = torch.as_tensor(relaxation, dtype=verts.dtype, device=verts.device)
    v = verts
    for _ in range(num_iterations):
        avg = torch.sum(v[nbr_table], dim=1) * inv_deg
        v = torch.where(movable, v + relax * (avg - v), v)
    return v


def smooth_mesh(mesh: Mesh, num_iterations: int = 150, relaxation: float = 0.01, device=None) -> Mesh:
    """Laplacian smoothing, vtkSmoothPolyDataFilter defaults (relaxation
    0.01), run on `device`."""
    if mesh.n_points == 0:
        return mesh
    dev = resolve_device(device)
    src, dst, _ = _adjacency(mesh)
    nv = mesh.n_points + 1
    tbl = _neighbor_table(src, dst, nv, nv - 1)
    vp = np.zeros((nv, 3), np.float32)
    vp[: mesh.n_points] = mesh.vertices
    out = _smooth_loop(torch.as_tensor(vp, device=dev), torch.as_tensor(tbl, device=dev),
                       int(num_iterations), relaxation)
    res = mesh.copy()
    res.vertices = out[: mesh.n_points].cpu().numpy()
    return res


def smooth_meshes(meshes, num_iterations: int = 150, relaxation: float = 0.01, device=None):
    """Smooth several meshes in one loop via their disjoint union (smoothing
    never crosses components, so the union is exact)."""
    meshes = list(meshes)
    if not meshes:
        return []
    offsets = np.cumsum([0] + [m.n_points for m in meshes])
    union = Mesh(
        np.concatenate([m.vertices for m in meshes]),
        np.concatenate([m.faces + offsets[i] for i, m in enumerate(meshes)]).astype(np.int32),
    )
    smoothed = smooth_mesh(union, num_iterations, relaxation, device)
    out = []
    for i, m in enumerate(meshes):
        r = m.copy()
        r.vertices = smoothed.vertices[offsets[i] : offsets[i + 1]]
        out.append(r)
    return out


def distance_to_surface_tensor(points: np.ndarray, target: Mesh, device=None) -> torch.Tensor:
    """Unsigned exact distance from each point to `target`'s surface, left on
    `device` (no host sync)."""
    dev = resolve_device(device)
    if target.n_cells == 0 or len(points) == 0:
        return torch.zeros(len(points), dtype=torch.float32, device=dev)
    pts = torch.as_tensor(np.ascontiguousarray(points, np.float32), device=dev)
    tris = torch.as_tensor(np.ascontiguousarray(target.triangles().reshape(-1, 9), np.float32), device=dev)
    return point_triangle_distance(pts, tris)


def distance_to_surface(points: np.ndarray, target: Mesh, device=None) -> np.ndarray:
    return distance_to_surface_tensor(points, target, device).cpu().numpy()


def get_distance(inner_mesh: Mesh, outer_mesh: Mesh, device=None):
    """Bidirectional unsigned surface distance — the thickness kernel
    (reference get_distance, mesh_processing.py:310-321)."""
    inner = inner_mesh.copy()
    outer = outer_mesh.copy()
    inner.point_data = distance_to_surface(inner.vertices, outer_mesh, device)
    outer.point_data = distance_to_surface(outer.vertices, inner_mesh, device)
    return inner, outer


_NN_QUERY_CHUNK = 2048
_NN_SOURCE_CHUNK = 8192


def _nn_indices(query: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Nearest source index per query point (port of ops.py:609-637): query
    chunks scan source chunks with a running (best d2, best index), d2 as
    sum((q - s)^2) in f32 as the JAX version forms it, and a later chunk
    taking over only when strictly nearer, so a tie keeps the first index."""
    out = torch.empty(len(query), dtype=torch.int64, device=query.device)
    for q0 in range(0, len(query), _NN_QUERY_CHUNK):
        qc = query[q0 : q0 + _NN_QUERY_CHUNK]
        best_d2 = torch.full((len(qc),), float("inf"), dtype=torch.float32, device=query.device)
        best_idx = torch.zeros(len(qc), dtype=torch.int64, device=query.device)
        for s0 in range(0, len(source), _NN_SOURCE_CHUNK):
            d2 = torch.sum((qc[:, None, :] - source[None, s0 : s0 + _NN_SOURCE_CHUNK, :]) ** 2, dim=-1)
            local_d2, local = torch.min(d2, dim=1)
            improve = local_d2 < best_d2
            best_d2 = torch.where(improve, local_d2, best_d2)
            best_idx = torch.where(improve, local + s0, best_idx)
        out[q0 : q0 + _NN_QUERY_CHUNK] = best_idx
    return out


def map_attributes(source_mesh: Mesh, target_mesh: Mesh, device=None) -> Mesh:
    """Transfer per-point scalars from source to target by closest point
    (reference map_attributes, mesh_processing.py:400-407), the search on
    `device`."""
    if source_mesh.point_data is None:
        raise ValueError("source mesh has no point_data to transfer")
    dev = resolve_device(device)
    src = torch.as_tensor(np.ascontiguousarray(source_mesh.vertices, np.float32), device=dev)
    query = torch.as_tensor(np.ascontiguousarray(target_mesh.vertices, np.float32), device=dev)
    idx = _nn_indices(query, src).cpu().numpy()
    out = target_mesh.copy()
    out.point_data = np.asarray(source_mesh.point_data)[idx]
    return out
