"""Connected components on triangle meshes + size filter (port of
`oai_analysis_2_tpu/mesh/components.py`, scipy path only).

Label point-connected components, drop every component with <=
`filter_threshold` cells (the reference keeps regions with more than 3000
cells, mesh_processing.py:127-136), and re-index. Host numpy/scipy.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.sparse.csgraph import connected_components

from oai_analysis_2_tpu_torch.mesh.types import Mesh


def connected_component_labels(mesh: Mesh) -> np.ndarray:
    """Per-point component label (0..k-1)."""
    rows = mesh.faces[:, [0, 1, 2]].reshape(-1)
    cols = mesh.faces[:, [1, 2, 0]].reshape(-1)
    g = sparse.coo_matrix(
        (np.ones(len(rows), np.int8), (rows, cols)), shape=(mesh.n_points, mesh.n_points)
    )
    _, labels = connected_components(g, directed=False)
    return labels


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
