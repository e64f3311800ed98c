"""Overlap-tile partition and assembly for patch-wise 3D inference (port of
`Partition`, `oai_analysis_2_tpu/ops/tiling.py:34-178`, reference
image_transforms.py:371-519), on torch tensors.

Semantics, the JAX package's:
  * sizes are given in x, y, z order and flipped to z, y, x;
  * effective = tile - 2 * overlap; grid = ceil(image / effective);
    pad = overlap before, (padded total - image - overlap) after;
  * tiles are ordered z-major (C order over the grid);
  * assembly keeps each tile's central region, crops to the image size and
    zeroes a boundary margin with the reference's axis quirk: a crop_size
    (cx, cy, cz) in x, y, z order is applied as margins (cz, cx, cy) on the
    (z, y, x) axes;
  * the vote: every tile votes over its full extent on the padded grid, the
    winner per voxel is the lowest class among the most votes.

The segmenter runs its own tiling loop on the card; this class is the
public tool for code written against the JAX package's API.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class Partition:
    def __init__(
        self,
        tile_size: Sequence[int],
        overlap_size: Sequence[int],
        padding_mode: str = "reflect",
    ):
        self.tile_size = tuple(int(v) for v in reversed(tuple(tile_size)))
        self.overlap_size = tuple(int(v) for v in reversed(tuple(overlap_size)))
        self.padding_mode = padding_mode
        for t, o in zip(self.tile_size, self.overlap_size):
            if t - 2 * o <= 0:
                raise ValueError(f"tile {t} must exceed 2*overlap {o}")

    def grid_shape(self, image_shape: Tuple[int, int, int]) -> Tuple[int, int, int]:
        return tuple(int(np.ceil(s / e)) for s, e in zip(image_shape, self.effective_size))

    @property
    def effective_size(self) -> Tuple[int, int, int]:
        return tuple(t - 2 * o for t, o in zip(self.tile_size, self.overlap_size))

    def num_tiles(self, image_shape: Tuple[int, int, int]) -> int:
        return int(np.prod(self.grid_shape(image_shape)))

    def _padded_total(self, image_shape) -> Tuple[int, int, int]:
        grid = self.grid_shape(image_shape)
        return tuple(e * g + 2 * o for e, g, o in zip(self.effective_size, grid, self.overlap_size))

    def _origins(self, image_shape):
        """(z0, y0, x0) of each tile on the padded grid, z-major."""
        eff = self.effective_size
        gz, gy, gx = self.grid_shape(image_shape)
        return [(i * eff[0], j * eff[1], k * eff[2]) for i in range(gz) for j in range(gy) for k in range(gx)]

    def _pad(self, volume: torch.Tensor) -> torch.Tensor:
        widths = [(o, pt - s - o) for o, pt, s in zip(self.overlap_size, self._padded_total(volume.shape), volume.shape)]
        if self.padding_mode == "constant":
            return F.pad(volume, [v for w in reversed(widths) for v in w])
        # numpy's pad modes (reflect, symmetric, edge, wrap) as index maps,
        # so a pad wider than the axis reflects again as np.pad / jnp.pad do
        for axis, (before, after) in enumerate(widths):
            idx = np.pad(np.arange(volume.shape[axis]), (before, after), mode=self.padding_mode)
            volume = volume.index_select(axis, torch.as_tensor(idx, device=volume.device))
        return volume

    def __call__(self, volume: torch.Tensor) -> torch.Tensor:
        """Split a (D, H, W) volume into (N, tz, ty, tx) tiles."""
        padded = self._pad(torch.as_tensor(volume))
        tz, ty, tx = self.tile_size
        return torch.stack([padded[z0 : z0 + tz, y0 : y0 + ty, x0 : x0 + tx]
                            for z0, y0, x0 in self._origins(volume.shape)])

    @staticmethod
    def _crop_mask(volume: torch.Tensor, image_shape, crop_size) -> torch.Tensor:
        # reference margin quirk: (cx, cy, cz) -> margins (cz, cx, cy) on (z, y, x)
        cz, cy, cx = int(crop_size[2]), int(crop_size[0]), int(crop_size[1])
        mask = torch.zeros(tuple(image_shape), dtype=volume.dtype, device=volume.device)
        mask[cz : image_shape[0] - cz, cy : image_shape[1] - cy, cx : image_shape[2] - cx] = 1
        return volume * mask

    def assemble(
        self,
        tiles: torch.Tensor,
        image_shape: Tuple[int, int, int],
        crop_size: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """Reassemble (N, tz, ty, tx) tiles into a (D, H, W) volume."""
        eff = self.effective_size
        grid = self.grid_shape(image_shape)
        ov = self.overlap_size
        tz, ty, tx = self.tile_size
        central = torch.as_tensor(tiles)[:, ov[0] : tz - ov[0], ov[1] : ty - ov[1], ov[2] : tx - ov[2]]
        # (gz, gy, gx, ez, ey, ex) -> (gz ez, gy ey, gx ex)
        volume = central.reshape(grid + eff).permute(0, 3, 1, 4, 2, 5).reshape(
            tuple(g * e for g, e in zip(grid, eff)))
        volume = volume[: image_shape[0], : image_shape[1], : image_shape[2]]
        return volume if crop_size is None else self._crop_mask(volume, image_shape, crop_size)

    def assemble_vote(
        self,
        tiles: torch.Tensor,
        image_shape: Tuple[int, int, int],
        n_classes: int,
        crop_size: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """Majority-vote reassembly of integer-label tiles (class indices
        0..n_classes-1): every tile votes over its full extent at its place
        on the padded grid, the winner per voxel is the argmax (ties to the
        lowest class), cropped to the image window; int32."""
        tiles = torch.as_tensor(tiles)
        tz, ty, tx = self.tile_size
        ov = self.overlap_size
        onehot = F.one_hot(tiles.to(torch.int64), n_classes).to(torch.int32)  # (N, tz, ty, tx, C)
        votes = torch.zeros(self._padded_total(image_shape) + (n_classes,), dtype=torch.int32, device=tiles.device)
        for idx, (z0, y0, x0) in enumerate(self._origins(image_shape)):
            votes[z0 : z0 + tz, y0 : y0 + ty, x0 : x0 + tx] += onehot[idx]
        seg = votes.argmax(-1).to(torch.int32)  # the first maximum: ties to the lowest class
        seg = seg[ov[0] : ov[0] + image_shape[0], ov[1] : ov[1] + image_shape[1], ov[2] : ov[2] + image_shape[2]]
        return seg if crop_size is None else self._crop_mask(seg, image_shape, crop_size)
