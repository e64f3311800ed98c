"""Physical-space image container (port of `oai_analysis_2_tpu/core/image.py`).

Conventions are the JAX package's (and ITK's):
  * `data` is indexed [z, y, x];
  * `origin`, `spacing` are length-3 float32 tensors in x, y, z order;
  * `direction` is a 3x3 float32 matrix in x, y, z order;
  * physical(index_xyz) = origin + direction @ (spacing * index_xyz).
Metadata tensors live on the same device as `data`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from oai_analysis_2_tpu_torch.core.device import resolve_device


def _apply_3x3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply a 3x3 matrix to (..., 3) vectors as elementwise f32 math, not a
    matmul — the same three multiply-adds the JAX package spells out, so
    millimetre coordinates round identically."""
    v = v.to(torch.float32)
    m = m.to(torch.float32)
    return v[..., 0:1] * m[:, 0] + v[..., 1:2] * m[:, 1] + v[..., 2:3] * m[:, 2]


@dataclasses.dataclass(frozen=True)
class Image:
    """A 3D volume with ITK-style physical-space metadata."""

    data: torch.Tensor  # (D, H, W) indexed z, y, x
    origin: torch.Tensor  # (3,) xyz
    spacing: torch.Tensor  # (3,) xyz
    direction: torch.Tensor  # (3, 3) xyz

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def index_to_physical_matrix(self) -> torch.Tensor:
        """3x3 matrix M with physical = origin + M @ index_xyz."""
        return self.direction * self.spacing[None, :]

    def physical_to_index_matrix(self) -> torch.Tensor:
        return torch.linalg.inv(self.index_to_physical_matrix())

    def indices_to_physical(self, idx_xyz: torch.Tensor) -> torch.Tensor:
        return _apply_3x3(self.index_to_physical_matrix(), idx_xyz) + self.origin

    def physical_to_indices(self, pts: torch.Tensor) -> torch.Tensor:
        return _apply_3x3(self.physical_to_index_matrix(), pts - self.origin)

    def astype(self, dtype) -> "Image":
        return dataclasses.replace(self, data=self.data.to(dtype))

    def with_data(self, data: torch.Tensor) -> "Image":
        """Same grid/metadata, new voxels."""
        return dataclasses.replace(self, data=data)

    def to(self, device) -> "Image":
        return Image(*(t.to(device) for t in (self.data, self.origin, self.spacing, self.direction)))

    def numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()


def image_from_array(
    data,
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
    direction=None,
    dtype=None,
    device=None,
) -> Image:
    """Build an Image from a [z, y, x] array with xyz-ordered metadata."""
    dev = resolve_device(device)
    arr = torch.as_tensor(np.asarray(data) if not torch.is_tensor(data) else data)
    arr = arr.to(device=dev, dtype=dtype) if dtype is not None else arr.to(dev)
    if direction is None:
        direction = np.eye(3, dtype=np.float32)

    def meta(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    return Image(data=arr, origin=meta(origin), spacing=meta(spacing), direction=meta(direction))


def physical_grid(shape_zyx, origin, spacing, direction) -> torch.Tensor:
    """Physical coordinates of every voxel of a grid, (D, H, W, 3) xyz, on
    the device of `origin`."""
    d, h, w = (int(s) for s in shape_zyx)
    dev = origin.device
    zz, yy, xx = torch.meshgrid(
        torch.arange(d, dtype=torch.float32, device=dev),
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    idx_xyz = torch.stack([xx, yy, zz], dim=-1)
    m = direction.to(torch.float32) * spacing.to(torch.float32)[None, :]
    return _apply_3x3(m, idx_xyz) + origin.to(torch.float32)
