"""Synthetic knee phantoms and the GradICON training step on them (port of
`oai_analysis_2_tpu/models/synthetic.py`).

`random_phantom` (`:34-99`), `random_lowres_field` and `make_phantom_pool`
(`:102-125`) are numpy copies: the same generator gives the JAX package's
arrays bit for bit (the offline atlas is
`random_phantom(np.random.default_rng(60), shape)`). `apply_lowres_warp`
and `make_augmented_train_step` (`:128-200`) are PyTorch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from oai_analysis_2_tpu_torch.models.gradicon import _index_scale, compose, identity_map, resize_field, warp
from oai_analysis_2_tpu_torch.utils.optim import batch_step


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


def random_lowres_field(
    rng: np.random.Generator,
    lowres_shape: Tuple[int, int, int] = (6, 12, 12),
    amplitude: float = 0.035,
    translation: float = 0.03,
) -> np.ndarray:
    """A random smooth displacement field in normalized [0, 1]-coordinate
    units at low resolution (lowres_shape + (3,), f32): a random amplitude
    in [0, amplitude) times unit normals, plus one random translation."""
    amp = rng.uniform(0.0, amplitude)
    field = rng.normal(0.0, 1.0, lowres_shape + (3,)).astype(np.float32) * amp
    field += rng.uniform(-translation, translation, (3,)).astype(np.float32)
    return field


def make_phantom_pool(n: int, shape_zyx: Tuple[int, int, int] = (48, 96, 96), seed: int = 0) -> np.ndarray:
    """(n, D, H, W) stack of independent phantoms."""
    rng = np.random.default_rng(seed)
    return np.stack([random_phantom(rng, shape_zyx) for _ in range(n)])


def apply_lowres_warp(volume: torch.Tensor, u_lowres: torch.Tensor) -> torch.Tensor:
    """Warp a (D, H, W) volume by a low-res normalized displacement field,
    upsampled trilinearly onto the volume's grid."""
    ident = identity_map(volume.shape, volume.device)
    return warp(volume, ident + resize_field(u_lowres, volume.shape))


def make_augmented_train_step(model, optimizer, sup_weight: float = 0.0, sim_weight: float = 1.0):
    """The GradICON train step with warp augmentation and known-correspondence
    supervision (port of synthetic.py:136-200).

    `step(vol_a, vol_b, u_a, u_b, same)`: vol_* (N, D, H, W) phantoms, u_*
    (N, *lowres, 3) normalized low-res fields, same (N,) f32, 1 where vol_a
    and vol_b are one phantom. Each volume is warped by its field; the loss
    of a pair is sim_weight * sim + lambda_reg * reg, plus for same pairs
    sup_weight times the composition residual (id + u_b) o phi_AB - (id +
    u_a), and its mirror, in voxels squared. One optimizer update of the
    batch mean; returns (loss, sim, reg, sup) means, sup gated by `same`.
    `optimizer` is a `utils.optim` optimizer over the model's parameters,
    whose gradients this turns on."""
    lambda_reg = model.config.lambda_reg

    def one(va, vb, ua_low, ub_low, s):
        shape = tuple(va.shape)
        ident = identity_map(shape, va.device)
        ua = ident + resize_field(ua_low, shape)
        ub = ident + resize_field(ub_low, shape)
        a, b = warp(va, ua), warp(vb, ub)
        _, (sim, reg, phi_ab, phi_ba) = model.loss(a, b)
        scale = _index_scale(shape, va.device)
        res_ab = (compose(ub, phi_ab) - ua) * scale
        res_ba = (compose(ua, phi_ba) - ub) * scale
        sup = 0.5 * (torch.mean(torch.sum(res_ab * res_ab, dim=-1)) + torch.mean(torch.sum(res_ba * res_ba, dim=-1)))
        loss = sim_weight * sim + lambda_reg * reg + s * sup_weight * sup
        return loss, (sim, reg, s * sup)

    def step(vol_a, vol_b, u_a, u_b, same):
        return tuple(batch_step(optimizer, one, (vol_a, vol_b, u_a, u_b, same)))

    optimizer.require_grad()
    return step
