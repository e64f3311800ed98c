"""Training-data sampling: class-balanced random 3D patches with axis
flips. A numpy copy of `oai_analysis_2_tpu/engine/sampling.py:18-82`: the
same seed yields the JAX package's batches bit for bit.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np


class BalancedPatchSampler:
    """Yields (images NDHWC, labels NDHWC) numpy batches of random patches; a
    `foreground_fraction` of the patches are centered on a random foreground
    voxel (any positive class), the rest sampled uniformly."""

    def __init__(
        self,
        volumes: Sequence[np.ndarray],  # each (D, H, W)
        labels: Sequence[np.ndarray],  # each (D, H, W, C) multi-hot
        patch_size_zyx: Tuple[int, int, int],
        batch_size: int = 4,
        foreground_fraction: float = 0.5,
        flip_axes: Tuple[int, ...] = (2,),  # x-flip (left/right knees)
        seed: int = 0,
    ):
        self.volumes = [np.asarray(v, np.float32) for v in volumes]
        self.labels = [np.asarray(lab, np.float32) for lab in labels]
        self.patch = tuple(patch_size_zyx)
        self.batch_size = batch_size
        self.fg_frac = foreground_fraction
        self.flip_axes = flip_axes
        self.rng = np.random.default_rng(seed)
        self._fg = []
        for lab in self.labels:
            fg = np.argwhere(lab.sum(axis=-1) > 0)
            self._fg.append(fg if len(fg) else np.zeros((1, 3), np.int64))

    def _random_origin(self, shape, center=None):
        out = []
        for ax in range(3):
            hi = shape[ax] - self.patch[ax]
            if center is None:
                out.append(self.rng.integers(0, max(hi, 0) + 1))
            else:
                o = int(center[ax]) - self.patch[ax] // 2
                out.append(int(np.clip(o, 0, max(hi, 0))))
        return out

    def _one(self):
        vi = self.rng.integers(0, len(self.volumes))
        vol, lab = self.volumes[vi], self.labels[vi]
        if self.rng.random() < self.fg_frac:
            center = self._fg[vi][self.rng.integers(0, len(self._fg[vi]))]
            z, y, x = self._random_origin(vol.shape, center)
        else:
            z, y, x = self._random_origin(vol.shape)
        pz, py, px = self.patch
        img = vol[z : z + pz, y : y + py, x : x + px]
        seg = lab[z : z + pz, y : y + py, x : x + px]
        for ax in self.flip_axes:
            if self.rng.random() < 0.5:
                img = np.flip(img, axis=ax)
                seg = np.flip(seg, axis=ax)
        return img, seg

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self):
        imgs, segs = zip(*(self._one() for _ in range(self.batch_size)))
        return np.stack(imgs)[..., None].copy(), np.stack(segs).copy()
