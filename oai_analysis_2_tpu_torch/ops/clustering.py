"""K-means (Lloyd) for the mesh split: the host path and the device path of
`oai_analysis_2_tpu/ops/clustering.py`.

Both backends use the same deterministic farthest-point start and a fixed
Lloyd schedule in float32. `backend=None` reads `OAI_TPU_KMEANS_BACKEND`
(the JAX package's variable and values: "host", the default, or
"device"); any other value raises `ValueError`.

* host (`:59-101`): numpy on the host, a copy of the JAX host path. The
  Lloyd distance keeps the f32 `||c||^2 - 2 x.c` form so labels, ties
  included, match it, and the loop stops when the labels repeat (a
  fixpoint of the fixed schedule).
* device (`_kmeans_impl`, `:24-57`): torch on `device` (None: the card),
  computed as JAX's jitted program: the full `sum((x - c)^2)` distance,
  padded rows weighted 0 and masked out of the farthest-point start, all
  `n_iter` steps with no host sync inside the loop, a centre whose count
  is 0 kept in place. One upload, one copy back. The one-hot sums
  `onehot^T @ x` go through `torch.matmul` in IEEE f32 whatever the
  caller's TF32 switches say (`core.device.ieee_f32_matmul`).

Label identity does not matter downstream: `mesh/split.py` re-derives inner
and outer from the normals.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from oai_analysis_2_tpu_torch.core.device import ieee_f32_matmul, resolve_device


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


def _sq_dist(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(P, N, D), (P, k, D) -> (P, N, k) squared distances, summed over D."""
    return torch.sum((x[:, :, None, :] - centers[:, None, :, :]) ** 2, dim=-1)


def _kmeans_torch(x: torch.Tensor, w: torch.Tensor, k: int, n_iter: int):
    """`_kmeans_impl` over a batch of problems: x (P, N, D) padded features,
    w (P, N) 1.0 for real rows and 0.0 for padding. Returns labels (P, N)
    and centres (P, k, D), both on x's device; nothing is read back."""
    p, _, d = x.shape
    rows = torch.arange(p, device=x.device)
    real = w > 0

    # deterministic farthest-point start among real rows
    total = torch.clamp(w.sum(dim=1), min=1.0)
    mean = (x * w[..., None]).sum(dim=1) / total[:, None]
    d2m = torch.sum((x - mean[:, None, :]) ** 2, dim=-1)
    first = torch.argmax(torch.where(real, d2m, -torch.inf), dim=1)
    centers = torch.zeros((p, k, d), dtype=x.dtype, device=x.device)
    centers[:, 0] = x[rows, first]
    slot = torch.arange(k, device=x.device)
    for i in range(1, k):
        blocked = torch.where(slot < i, 0.0, torch.inf).to(x.dtype)
        d2 = torch.min(_sq_dist(x, centers) + blocked, dim=2).values
        centers[:, i] = x[rows, torch.argmax(torch.where(real, d2, -torch.inf), dim=1)]

    for _ in range(n_iter):
        labels = torch.argmin(_sq_dist(x, centers), dim=2)
        onehot = (labels[..., None] == slot).to(x.dtype) * w[..., None]
        counts = onehot.sum(dim=1)[..., None]
        with ieee_f32_matmul():
            sums = torch.matmul(onehot.transpose(1, 2), x)
        centers = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), centers)
    return torch.argmin(_sq_dist(x, centers), dim=2), centers


def _solve_on_device(arrs, k: int, n_iter: int, device, with_centers: bool):
    """Every problem padded to a shared (n_max, d_max) and solved in one
    batched pass: zero-weight rows and zero feature columns change no
    distance, so each answer equals the problem's standalone one. (JAX pads
    to power-of-two row buckets only so that XLA compiles once a bucket.)
    Returns the labels of each problem and, if asked, its centres."""
    dev = resolve_device(device)
    n_max = max(len(a) for a in arrs)
    d_max = max(a.shape[1] for a in arrs)
    # features and the row weight in one buffer: one upload
    buf = np.zeros((len(arrs), n_max, d_max + 1), np.float32)
    for i, a in enumerate(arrs):
        buf[i, : len(a), : a.shape[1]] = a
        buf[i, : len(a), d_max] = 1.0
    xw = torch.from_numpy(buf).to(dev)
    labels, centers = _kmeans_torch(xw[..., :d_max], xw[..., d_max], int(k), int(n_iter))
    # labels (< k) are exact in f32: labels and centres come back in one copy
    parts = [labels.to(torch.float32).reshape(-1)]
    if with_centers:
        parts.append(centers.reshape(-1))
    host = torch.cat(parts).cpu().numpy()
    lab = host[: labels.numel()].astype(np.int32).reshape(len(arrs), n_max)
    out_labels = [lab[i, : len(a)] for i, a in enumerate(arrs)]
    if not with_centers:
        return out_labels, None
    cen = host[labels.numel() :].reshape(len(arrs), int(k), d_max)
    return out_labels, [cen[i, :, : a.shape[1]].copy() for i, a in enumerate(arrs)]


def _backend(override: str | None) -> str:
    b = override or os.environ.get("OAI_TPU_KMEANS_BACKEND", "host")
    if b not in ("host", "device"):
        raise ValueError(f"kmeans backend must be 'host' or 'device', got {b!r}")
    return b


def kmeans(x: np.ndarray, k: int = 2, n_iter: int = 50, backend: str | None = None, device=None):
    """Returns (labels (n,), centers (k, dim)) as numpy. Deterministic.

    backend "host" (the default, or `OAI_TPU_KMEANS_BACKEND`): numpy in
    place. "device": the batched torch program on `device` (None: the
    card, raising without one)."""
    x = np.asarray(x, np.float32)
    if _backend(backend) == "host":
        return _kmeans_np(x, int(k), int(n_iter))
    labels, centers = _solve_on_device([x], k, n_iter, device, with_centers=True)
    return labels[0], centers[0]


def kmeans_many(problems, k: int = 2, n_iter: int = 50, backend: str | None = None, device=None):
    """Labels for each of several independent (n_i, d_i) problems, aligned
    with the inputs. Host: each problem solved in place with numpy.
    Device: one batched pass for the whole set on `device` (None: the
    card); each answer equals its standalone `kmeans` up to argmin ties."""
    if not problems:
        return []
    arrs = [np.asarray(p, np.float32) for p in problems]
    if _backend(backend) == "host":
        return [_kmeans_np(a, int(k), int(n_iter))[0] for a in arrs]
    return _solve_on_device(arrs, k, n_iter, device, with_centers=False)[0]
