"""Connected components on triangle meshes + size filter (port of
`oai_analysis_2_tpu/mesh/components.py`).

Label point-connected components, drop every component with <=
`filter_threshold` cells (the reference keeps regions with more than 3000
cells, mesh_processing.py:127-136), and re-index. The labels come from the
host-geometry library's union-find (`native.connected_components`), as the
JAX package's do; `scipy_component_labels` is the plain version the tests
hold it against.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.sparse.csgraph import connected_components

from oai_analysis_2_tpu_torch import native
from oai_analysis_2_tpu_torch.mesh.types import Mesh


def _union_find_labels(n_points: int, faces: np.ndarray) -> np.ndarray:
    """Per-point component label (0..k-1) by union-find in C++
    (components.py:19-34)."""
    return native.connected_components(n_points, faces)


def scipy_component_labels(n_points: int, faces: np.ndarray) -> np.ndarray:
    """Plain version of `_union_find_labels`: scipy's connected components
    of the faces' edge graph."""
    rows = faces[:, [0, 1, 2]].reshape(-1)
    cols = faces[:, [1, 2, 0]].reshape(-1)
    g = sparse.coo_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(n_points, n_points))
    _, labels = connected_components(g, directed=False)
    return labels


def connected_component_labels(mesh: Mesh) -> np.ndarray:
    """Per-point component label (0..k-1)."""
    return _union_find_labels(mesh.n_points, mesh.faces)


def filter_small_components(mesh: Mesh, filter_threshold: int = 3000) -> Mesh:
    """Keep only components with more than `filter_threshold` cells."""
    if mesh.n_cells == 0:
        return mesh
    labels = connected_component_labels(mesh)
    face_labels = labels[mesh.faces[:, 0]]
    counts = np.bincount(face_labels)
    keep_components = np.nonzero(counts > filter_threshold)[0]
    keep_faces = np.isin(face_labels, keep_components)
    return extract_faces(mesh, np.nonzero(keep_faces)[0])


def extract_faces(mesh: Mesh, face_indices: np.ndarray) -> Mesh:
    """Sub-mesh of selected faces with re-indexed, compacted vertices."""
    faces = mesh.faces[np.asarray(face_indices, np.int64)]
    used, new_faces = np.unique(faces.reshape(-1), return_inverse=True)
    out = Mesh(mesh.vertices[used], new_faces.reshape(-1, 3).astype(np.int32))
    if mesh.point_data is not None:
        out.point_data = np.asarray(mesh.point_data)[used]
    if mesh.cell_data is not None:
        out.cell_data = np.asarray(mesh.cell_data)[np.asarray(face_indices, np.int64)]
    return out
