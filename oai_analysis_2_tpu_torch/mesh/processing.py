"""Probability maps -> meshes (port of `get_mesh`, `_as_xyz` and
`get_thickness_meshes`, `oai_analysis_2_tpu/mesh/processing.py:83-255`;
`split_mesh` is exported here as there).

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
from oai_analysis_2_tpu_torch.mesh.ops import distance_to_surface_tensor, smooth_mesh, smooth_meshes
from oai_analysis_2_tpu_torch.mesh.split import split_mesh, split_meshes
from oai_analysis_2_tpu_torch.mesh.types import Mesh

__all__ = ["get_mesh", "get_thickness_meshes", "split_mesh"]


def _as_xyz(image: Image) -> torch.Tensor:
    """[z, y, x] image data -> [x, y, z] f32 volume on the image's device."""
    return image.data.to(torch.float32).permute(2, 1, 0).contiguous()


def _spacing(image: Image):
    return tuple(float(s) for s in image.spacing.cpu().numpy())


def get_mesh(image: Image, num_iterations: int = 150, level: float = 0.5,
             filter_threshold: int = 3000) -> Mesh:
    """Probability map -> smoothed surface mesh: marching cubes at `level`
    on the [x, y, z] volume with spacing-scaled coordinates, components of
    `filter_threshold` cells or fewer dropped, Laplacian smoothing on the
    image's device."""
    raw = marching_cubes(_as_xyz(image), level, _spacing(image))
    mesh = filter_small_components(raw, filter_threshold)
    return smooth_mesh(mesh, num_iterations=num_iterations, device=image.device)


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
