"""Overlap-tile geometry (port of the `Partition` geometry in
`oai_analysis_2_tpu/ops/tiling.py:34-64`).

Only what the segmenter reads is ported: sizes are given in x, y, z order
and flipped to z, y, x; effective = tile - 2 * overlap; grid =
ceil(image / effective). Tile extraction and assembly live in the
segmenter's loop.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


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
