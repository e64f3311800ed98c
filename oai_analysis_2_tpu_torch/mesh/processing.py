"""Probability maps -> meshes: the reference `mesh_processing.py` surface
(port of `oai_analysis_2_tpu/mesh/processing.py:58-255`; `split_mesh` is
exported here as there). Iso-surfaces are marching cubes only: method
"tets" (marching tetrahedra) raises until it is ported.

Single-device form: marching cubes and smoothing on the card, component
filtering and the k-means split on the host, the point-to-triangle
distance through the hand-written kernel.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from oai_analysis_2_tpu_torch.core.device import synchronize
from oai_analysis_2_tpu_torch.core.image import Image
from oai_analysis_2_tpu_torch.mesh.components import filter_small_components
from oai_analysis_2_tpu_torch.mesh.marching_cubes import marching_cubes
from oai_analysis_2_tpu_torch.mesh.ops import (
    distance_to_surface_tensor,
    face_centroids,
    face_normals,
    get_distance,
    smooth_mesh,
    smooth_meshes,
)
from oai_analysis_2_tpu_torch.mesh.split import split_mesh, split_meshes
from oai_analysis_2_tpu_torch.mesh.types import Mesh

__all__ = [
    "get_cell_centroid",
    "get_cell_normals",
    "get_mesh",
    "get_mesh_from_probability_map",
    "get_thickness_mesh",
    "get_thickness_meshes",
    "get_vtk_mesh",
    "split_mesh",
]


def get_cell_centroid(mesh: Mesh) -> np.ndarray:
    """(F, 3) per-face centroids."""
    return face_centroids(mesh)


def get_cell_normals(mesh: Mesh) -> np.ndarray:
    """(F, 3) per-face unit normals."""
    return face_normals(mesh)


def get_vtk_mesh(verts: np.ndarray, faces: np.ndarray, filter_threshold: int = 3000) -> Mesh:
    """A mesh from raw arrays with components of `filter_threshold` cells or
    fewer dropped."""
    return filter_small_components(Mesh(verts, faces), filter_threshold)


def _as_xyz(image: Image) -> torch.Tensor:
    """[z, y, x] image data -> [x, y, z] f32 volume on the image's device."""
    return image.data.to(torch.float32).permute(2, 1, 0).contiguous()


def _spacing(image: Image):
    return tuple(float(s) for s in image.spacing.cpu().numpy())


def _extract(image: Image, level: float, method: str) -> Mesh:
    if method == "mc":
        return marching_cubes(_as_xyz(image), level, _spacing(image))
    if method == "tets":
        raise NotImplementedError("method 'tets' (marching tetrahedra) is not ported yet; use 'mc'")
    raise ValueError(f"unknown iso-surface method {method!r} (use 'mc' or 'tets')")


def get_mesh(image: Image, num_iterations: int = 150, level: float = 0.5,
             filter_threshold: int = 3000, method: str = "mc") -> Mesh:
    """Probability map -> smoothed surface mesh: marching cubes at `level`
    on the [x, y, z] volume with spacing-scaled coordinates, components of
    `filter_threshold` cells or fewer dropped, Laplacian smoothing on the
    image's device."""
    raw = _extract(image, level, method)
    mesh = filter_small_components(raw, filter_threshold)
    return smooth_mesh(mesh, num_iterations=num_iterations, device=image.device)


def get_mesh_from_probability_map(image: Image, level: float = 0.5, method: str = "mc") -> Mesh:
    """The iso-surface alone: no component filtering, no smoothing."""
    return _extract(image, level, method)


def get_thickness_mesh(image: Image, mesh_type: str = "FC", num_iterations: int = 150, method: str = "mc"):
    """One tissue's probability map -> (inner, outer) meshes with per-point
    thickness, the distance to the other surface."""
    mesh = get_mesh(image, num_iterations=num_iterations, method=method)
    inner_mesh, outer_mesh = split_mesh(mesh, mesh_type)
    return get_distance(inner_mesh, outer_mesh, device=image.device)


def get_thickness_meshes(images, mesh_types, num_iterations: int = 150, level: float = 0.5,
                         filter_threshold: int = 3000, timings_out: Optional[dict] = None):
    """For each probability map and its type ("FC" / "TC"): iso-surface,
    small-component removal, Laplacian smoothing (all tissues in one loop),
    inner/outer split, and per-point thickness as the distance to the other
    surface. Returns [(inner, outer), ...]; `timings_out` receives
    per-substage seconds."""
    images = list(images)
    dev = images[0].device
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        if timings_out is not None:
            synchronize(dev)
            now = time.perf_counter()
            timings_out[name] = round(now - t, 4)
            t = now

    extracted = [
        marching_cubes(_as_xyz(im), level, _spacing(im))
        for im in images
    ]
    mark("mc")
    raws = [filter_small_components(r, filter_threshold) for r in extracted]
    mark("components")
    smoothed = smooth_meshes(raws, num_iterations=num_iterations, device=dev)
    mark("smooth")
    splits = split_meshes(smoothed, list(mesh_types))
    mark("split")
    pending = [
        (inner, outer, distance_to_surface_tensor(inner.vertices, outer, dev),
         distance_to_surface_tensor(outer.vertices, inner, dev))
        for inner, outer in splits
    ]
    out = []
    for inner, outer, d_in, d_out in pending:
        inner, outer = inner.copy(), outer.copy()
        inner.point_data = d_in.cpu().numpy()
        outer.point_data = d_out.cpu().numpy()
        out.append((inner, outer))
    mark("distance")
    return out
