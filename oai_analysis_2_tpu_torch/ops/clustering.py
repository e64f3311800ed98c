"""Host k-means (copy of the host path of `oai_analysis_2_tpu/ops/clustering.py:59-169`).

Deterministic farthest-point seeding + Lloyd in float32 numpy. The
mesh-split problems are tiny (k=2, d<=6, ~50k rows) and their features
originate on the host, so they stay there. The Lloyd distance keeps the
f32 `||c||^2 - 2 x.c` form of the JAX package so labels, ties included,
match it.
"""

from __future__ import annotations

import numpy as np


def _kmeans_np(x: np.ndarray, k: int, n_iter: int):
    x = np.ascontiguousarray(x, np.float32)
    mean = x.mean(axis=0, dtype=np.float32)
    d2 = ((x - mean) ** 2).sum(axis=1)
    centers = np.zeros((k, x.shape[1]), np.float32)
    centers[0] = x[int(np.argmax(d2))]
    d2 = ((x - centers[0]) ** 2).sum(axis=1)
    for i in range(1, k):
        centers[i] = x[int(np.argmax(d2))]
        if i + 1 < k:
            d2 = np.minimum(d2, ((x - centers[i]) ** 2).sum(axis=1))
    # Lloyd; stops when the labels repeat (a fixpoint of the fixed schedule)
    prev = None
    labels = None
    for _ in range(n_iter):
        d2 = (centers * centers).sum(axis=1) - 2.0 * (x @ centers.T)
        labels = np.argmin(d2, axis=1)
        if prev is not None and np.array_equal(labels, prev):
            return labels, centers
        prev = labels
        onehot = (labels[:, None] == np.arange(k)[None, :]).astype(np.float32)
        counts = onehot.sum(axis=0)
        sums = onehot.T @ x
        nz = counts > 0
        centers[nz] = sums[nz] / counts[nz, None]
    d2 = (centers * centers).sum(axis=1) - 2.0 * (x @ centers.T)
    return np.argmin(d2, axis=1), centers


def kmeans(x: np.ndarray, k: int = 2, n_iter: int = 50):
    """Returns (labels (n,), centers (k, dim)). Deterministic."""
    return _kmeans_np(np.asarray(x, np.float32), int(k), int(n_iter))


def kmeans_many(problems, k: int = 2, n_iter: int = 50):
    """Labels for each of several independent problems."""
    return [_kmeans_np(np.asarray(p, np.float32), int(k), int(n_iter))[0] for p in problems]
