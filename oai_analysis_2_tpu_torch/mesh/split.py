"""Inner/outer cartilage surface splitting (copy of
`oai_analysis_2_tpu/mesh/split.py`, imports pointing into the port).

The reference's clustering splits (mesh_processing.py:197-294):
  * tibial cartilage: one k=2 clustering of [normalized centroids x1,
    normals x10]; the cluster whose mean +y normal is positive is "inner";
  * femoral cartilage: the x-range is cut into `num_divisions` bands, each
    band clustered separately on [normalized centroids, normals,
    (center - centroid) * normal], labels stitched; same +y orientation rule.

Clustering is the host k-means (ops.clustering); the orientation heuristic
— not RNG-stream identity — fixes which side is inner.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from oai_analysis_2_tpu_torch.mesh.components import extract_faces
from oai_analysis_2_tpu_torch.mesh.ops import face_centroids, face_normals
from oai_analysis_2_tpu_torch.mesh.types import Mesh
from oai_analysis_2_tpu_torch.ops.clustering import kmeans, kmeans_many


def _normalize_centroids(c: np.ndarray) -> np.ndarray:
    if len(c) == 0:
        return c
    span = c.max(axis=0) - c.min(axis=0)
    return (c - c.mean(axis=0)) / np.where(span > 0, span, 1.0)


def _orient_inner(labels_pm1: np.ndarray, normals: np.ndarray) -> np.ndarray:
    """Flip labels so the -1 cluster has mean positive y-normal ("inner")."""
    if not np.any(labels_pm1 == -1):
        return -labels_pm1
    if normals[labels_pm1 == -1, 1].mean() < 0:
        labels_pm1 = -labels_pm1
    return labels_pm1


def _tibial_problems(mesh: Mesh, mesh_normals, mesh_centroids):
    """(clustering problems, finisher(label_list) -> face-label array)."""
    feats = np.concatenate(
        [_normalize_centroids(mesh_centroids) * 1.0, mesh_normals * 10.0], axis=1
    )

    def finish(label_list):
        labels = _orient_inner(label_list[0] * 2 - 1, mesh_normals)
        return labels

    return [feats], finish


def _femoral_problems(mesh: Mesh, face_normal, face_centroid, num_divisions: int = 3):
    centroids_norm = _normalize_centroids(face_centroid)
    lo = mesh.vertices.min(axis=0)
    hi = mesh.vertices.max(axis=0)
    center = (lo + hi) / 2.0
    dot = (center - face_centroid) * face_normal  # per-axis products, as upstream

    x = centroids_norm[:, 0]
    min_x, max_x = x.min(), x.max()
    step = (max_x - min_x) / num_divisions
    problems, idxs = [], []
    for i in range(num_divisions):
        lo_x = min_x + step * i
        hi_x = lo_x + step
        idx = np.nonzero((x >= lo_x) & (x < hi_x))[0]
        if len(idx) < 2:
            continue
        problems.append(
            np.concatenate(
                [centroids_norm[idx], face_normal[idx], dot[idx]], axis=1
            )
        )
        idxs.append(idx)

    def finish(label_list):
        labels = np.zeros(len(face_centroid))
        for idx, band in zip(idxs, label_list):
            labels[idx] = _orient_inner(band * 2 - 1, face_normal[idx])
        return labels

    return problems, finish


def _split_problems(mesh: Mesh, mesh_type: str):
    """(problems, finisher(label_list) -> (inner, outer)) for one mesh —
    the clustering is deferred so `split_meshes` can solve every problem of
    a batch in ONE device call (kmeans_many)."""
    if mesh.n_cells < 2:
        # empty/degenerate surface (e.g. all-zero probability map): nothing to
        # split — return two empty meshes instead of crashing downstream
        empty = Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

        return [], lambda _: (empty, empty.copy())
    normals = face_normals(mesh)
    centroids = face_centroids(mesh)
    if mesh_type == "FC":
        problems, finish_labels = _femoral_problems(mesh, normals, centroids)
    else:
        problems, finish_labels = _tibial_problems(mesh, normals, centroids)

    def finish(label_list):
        labels = finish_labels(label_list)
        inner = extract_faces(mesh, np.nonzero(labels == -1)[0])
        outer = extract_faces(mesh, np.nonzero(labels == 1)[0])
        return inner, outer

    return problems, finish


def split_tibial_cartilage_surface(
    mesh: Mesh, mesh_normals: np.ndarray, mesh_centroids: np.ndarray
) -> Tuple[Mesh, Mesh, np.ndarray, np.ndarray]:
    problems, finish_labels = _tibial_problems(mesh, mesh_normals, mesh_centroids)
    labels = finish_labels([kmeans(p, k=2)[0] for p in problems])
    inner_faces = np.nonzero(labels == -1)[0]
    outer_faces = np.nonzero(labels == 1)[0]
    return (
        extract_faces(mesh, inner_faces),
        extract_faces(mesh, outer_faces),
        inner_faces,
        outer_faces,
    )


def split_femoral_cartilage_surface(
    mesh: Mesh,
    face_normal: np.ndarray,
    face_centroid: np.ndarray,
    num_divisions: int = 3,
) -> Tuple[Mesh, Mesh, np.ndarray, np.ndarray]:
    problems, finish_labels = _femoral_problems(
        mesh, face_normal, face_centroid, num_divisions
    )
    labels = finish_labels([kmeans(p, k=2)[0] for p in problems])
    inner_faces = np.nonzero(labels == -1)[0]
    outer_faces = np.nonzero(labels == 1)[0]
    return (
        extract_faces(mesh, inner_faces),
        extract_faces(mesh, outer_faces),
        inner_faces,
        outer_faces,
    )


def split_mesh(mesh: Mesh, mesh_type: str = "FC") -> Tuple[Mesh, Mesh]:
    """Dispatch FC/TC split (reference split_mesh, mesh_processing.py:353-377)."""
    return split_meshes([mesh], [mesh_type])[0]


def split_meshes(meshes, mesh_types):
    """Split several meshes; returns [(inner, outer), ...] identical to
    per-mesh `split_mesh`."""
    specs = [_split_problems(m, t) for m, t in zip(meshes, mesh_types)]
    flat = [p for problems, _ in specs for p in problems]
    solutions = kmeans_many(flat, k=2)
    out = []
    i = 0
    for problems, finish in specs:
        out.append(finish(solutions[i : i + len(problems)]))
        i += len(problems)
    return out
