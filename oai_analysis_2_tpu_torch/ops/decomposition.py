"""Linear (kernel) PCA and least-squares circle fitting (port of
`oai_analysis_2_tpu/ops/decomposition.py`).

`linear_kpca` is a host numpy copy (SVD with sklearn's sign convention);
the circle fit is the same 20 Gauss-Newton steps in f32 from the centroid,
with the Jacobian written out. Both take and return host arrays: the fits
run once per atlas mesh and are a few thousand flops.
"""

from __future__ import annotations

import numpy as np
import torch


def linear_kpca(x: np.ndarray, n_components: int = 2) -> np.ndarray:
    """Project points onto their top principal components (linear-kernel
    KernelPCA scores; copy of decomposition.py:21-35)."""
    x = np.asarray(x, np.float64)
    xc = x - x.mean(axis=0)
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    scores = u[:, :n_components] * s[:n_components]
    # deterministic signs (sklearn svd_flip): largest-|.| entry of each u
    # column made positive
    for j in range(scores.shape[1]):
        col = u[:, j]
        if col[np.argmax(np.abs(col))] < 0:
            scores[:, j] = -scores[:, j]
    return scores.astype(np.float32)


def compute_least_square_circle(x: np.ndarray, y: np.ndarray):
    """(center (2,), radius) minimizing sum_i (r_i(c) - mean(r(c)))^2 by
    Gauss-Newton from the centroid (decomposition.py:38-64): the residual's
    Jacobian is d r_i / dc = -(p_i - c) / r_i minus its mean."""
    x = torch.as_tensor(np.asarray(x, np.float32))
    y = torch.as_tensor(np.asarray(y, np.float32))
    c = torch.stack([x.mean(), y.mean()])
    eye = torch.eye(2, dtype=torch.float32)
    for _ in range(20):
        dx, dy = x - c[0], y - c[1]
        r = torch.sqrt(dx * dx + dy * dy)
        f = r - r.mean()
        dr = torch.stack([-dx / r, -dy / r], dim=1)
        jac = dr - dr.mean(dim=0)
        c = c - torch.linalg.solve(jac.T @ jac + 1e-12 * eye, jac.T @ f)
    r = torch.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2).mean()
    return c.numpy(), float(r)
