"""2D thickness mapping: FC cylindrical unrolling, TC planar projection
(host numpy copy of `oai_analysis_2_tpu/mesh/projection.py:20-118`).

  * FC: swap x/y, least-squares circle fit of the (x, y) footprint, unroll
    to (angle, z) cylindrical coordinates;
  * TC: split plateaus at z=50, 2-component linear KPCA per side, rotate
    -50 deg / -160 deg, flip right x, offset right y by +50, concatenate.

One difference: `rasterize_thickness` drops points with a non-finite
coordinate or thickness, where the JAX version casts NaN to an integer bin
(ROADMAP.md, Queue 3).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from oai_analysis_2_tpu_torch.mesh.types import Mesh
from oai_analysis_2_tpu_torch.ops.decomposition import compute_least_square_circle, linear_kpca


def get_cylinder(vertices: np.ndarray):
    """Circle fit of the (x, y) footprint + z range."""
    x, y = vertices[:, 0], vertices[:, 1]
    center, r = compute_least_square_circle(x, y)
    return (center, r), (vertices[:, 2].min(), vertices[:, 2].max())


def get_projection_from_circle_and_vertice(vertices: np.ndarray, circle):
    """Cylindrical unrolling: angle about the fitted center + z."""

    def equal_scale(v, ref):
        v = (v - v.min()) / max(v.max() - v.min(), 1e-20)
        return v * (ref.max() - ref.min()) * 1.5 + ref.min()

    center, _ = circle
    radian = np.arctan2(vertices[:, 1] - center[1], vertices[:, 0] - center[0])
    embedded = np.stack([radian, vertices[:, 2]], axis=1)

    angle = equal_scale(radian / np.pi * 180.0, vertices[:, 2])
    plot_xy = np.stack([angle, vertices[:, 2]], axis=1)
    return embedded, plot_xy


def _rotate2d(pts: np.ndarray, angle_deg: float) -> np.ndarray:
    t = np.deg2rad(angle_deg)
    rot = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    return pts @ rot


def project_thickness(mapped_mesh: Mesh, mesh_type: str = "FC") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x_2d, y_2d, thickness) per point."""
    thickness = np.asarray(mapped_mesh.point_data, np.float32)

    if mesh_type == "FC":
        verts = np.array(mapped_mesh.vertices, np.float32)
        verts[:, [1, 0]] = verts[:, [0, 1]]  # the reference swaps x/y
        circle, _ = get_cylinder(verts)
        emb, _ = get_projection_from_circle_and_vertice(verts, circle)
        return emb[:, 0], emb[:, 1], thickness

    verts = np.asarray(mapped_mesh.vertices, np.float32)
    left = verts[:, 2] < 50
    right = ~left
    idx_left = np.nonzero(left)[0]
    idx_right = np.nonzero(right)[0]

    def _side(pts, angle):
        # a plateau is empty when the mesh lies on one side of z = 50
        if len(pts) == 0:
            return np.zeros((0, 2), np.float32)
        return _rotate2d(linear_kpca(pts), angle)

    emb_left = _side(verts[left], -50.0)
    emb_right = _side(verts[right], -160.0)
    emb_right[:, 0] = -emb_right[:, 0]

    x2d = np.concatenate([emb_right[:, 0], emb_left[:, 0]])
    y2d = np.concatenate([emb_right[:, 1] + 50.0, emb_left[:, 1]])
    th = np.concatenate([thickness[idx_right], thickness[idx_left]])
    return x2d, y2d, th


def rasterize_thickness(
    x2d: np.ndarray,
    y2d: np.ndarray,
    thickness: np.ndarray,
    grid_size: Tuple[int, int] = (128, 128),
    bounds=None,
):
    """Average scattered projected thickness onto a regular 2D grid:
    (mean_map (H, W), count_map (H, W), (xmin, xmax, ymin, ymax)). Points
    with a non-finite coordinate or thickness are dropped."""
    x2d = np.asarray(x2d, np.float64)
    y2d = np.asarray(y2d, np.float64)
    thickness = np.asarray(thickness, np.float64)
    keep = np.isfinite(x2d) & np.isfinite(y2d) & np.isfinite(thickness)
    x2d, y2d, thickness = x2d[keep], y2d[keep], thickness[keep]
    if bounds is None:
        bounds = (x2d.min(), x2d.max(), y2d.min(), y2d.max())
    xmin, xmax, ymin, ymax = bounds
    h, w = grid_size
    xi = np.clip(((x2d - xmin) / max(xmax - xmin, 1e-12) * (w - 1)).astype(int), 0, w - 1)
    yi = np.clip(((y2d - ymin) / max(ymax - ymin, 1e-12) * (h - 1)).astype(int), 0, h - 1)
    flat = yi * w + xi
    # N.B. bincount returns int64 (not float64) for an EMPTY weights array
    sums = np.bincount(flat, weights=thickness, minlength=h * w).reshape(h, w)
    sums = sums.astype(np.float64, copy=False)
    counts = np.bincount(flat, minlength=h * w).reshape(h, w)
    mean = np.divide(sums, counts, out=np.zeros_like(sums), where=counts > 0)
    return mean.astype(np.float32), counts.astype(np.int32), bounds
