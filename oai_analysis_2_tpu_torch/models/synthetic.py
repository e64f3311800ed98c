"""Synthetic knee phantom (copy of `random_phantom`,
`oai_analysis_2_tpu/models/synthetic.py:34-99`, numpy only).

The offline atlas is `random_phantom(np.random.default_rng(60), shape)`,
so the same generator gives the JAX package's atlas voxel for voxel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def random_phantom(
    rng: np.random.Generator, shape_zyx: Tuple[int, int, int] = (48, 96, 96)
) -> np.ndarray:
    """A windowed-intensity knee-like volume in [0, 1].

    1-3 cartilage-like shells (curved thin caps, the structures the
    production registration must align — cf. the bench's `_shell_probmap`),
    0-2 solid ellipsoids (bone-like bulk), low-frequency illumination bias,
    and uniform texture noise. All geometry parameters are randomized so the
    trained network cannot memorize a template.
    """
    d, h, w = shape_zyx
    z, y, x = np.meshgrid(
        np.arange(d, dtype=np.float32),
        np.arange(h, dtype=np.float32),
        np.arange(w, dtype=np.float32),
        indexing="ij",
    )
    anatomy = np.zeros(shape_zyx, np.float32)

    for _ in range(int(rng.integers(1, 4))):  # shells
        c = (
            d * rng.uniform(0.3, 0.7),
            h * rng.uniform(0.35, 0.7),
            w * rng.uniform(0.35, 0.65),
        )
        aspect_z = rng.uniform(1.6, 3.0)
        r0 = rng.uniform(0.10, 0.24) * h
        th = rng.uniform(1.0, 3.5)
        rr = np.sqrt(((z - c[0]) * aspect_z) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
        shell = np.clip(1.0 - np.abs(rr - r0) / th, 0.0, 1.0)
        cap_kind = int(rng.integers(0, 3))
        if cap_kind == 0:
            cap = (y < c[1]).astype(np.float32)
        elif cap_kind == 1:
            cap = (y > c[1]).astype(np.float32)
        else:
            cap = 1.0
        anatomy = np.maximum(anatomy, shell * cap * rng.uniform(0.55, 0.95))

    for _ in range(int(rng.integers(0, 3))):  # bone-like ellipsoids
        c = (
            d * rng.uniform(0.25, 0.75),
            h * rng.uniform(0.25, 0.75),
            w * rng.uniform(0.3, 0.7),
        )
        radii = (
            d * rng.uniform(0.08, 0.2),
            h * rng.uniform(0.08, 0.2),
            w * rng.uniform(0.08, 0.2),
        )
        q = (
            ((z - c[0]) / radii[0]) ** 2
            + ((y - c[1]) / radii[1]) ** 2
            + ((x - c[2]) / radii[2]) ** 2
        )
        blob = np.clip(2.0 * (1.0 - q), 0.0, 1.0)
        anatomy = np.maximum(anatomy, blob * rng.uniform(0.3, 0.7))

    # low-frequency illumination bias + uniform texture noise
    bias = (
        rng.uniform(-0.06, 0.06) * np.sin(z / d * rng.uniform(2, 5) + rng.uniform(0, 6))
        + rng.uniform(-0.06, 0.06) * np.sin(y / h * rng.uniform(2, 5) + rng.uniform(0, 6))
    )
    noise = rng.uniform(0.0, rng.uniform(0.12, 0.28), shape_zyx)
    return np.clip(anatomy + noise + bias, 0.0, 1.0).astype(np.float32)
