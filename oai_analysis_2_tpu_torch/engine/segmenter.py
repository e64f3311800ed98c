"""Patch-wise 3D segmentation engine (port of
`oai_analysis_2_tpu/engine/segmenter.py`).

The volume is reflect-padded, cut into overlapping tiles (by default
x,y-spanning z-slabs), each tile batch runs through the UNet, the tiles'
central regions are written into a preallocated canvas, and a boundary
margin is zeroed with the reference's crop-axis quirk.

Config keys mirror the reference: ckpoint_path (the reference's torch
`.pth.tar`, converted on load, or a native `.npz`), training_config_file,
batch_size, overlap_size, output_prob, output_itk, plus `compute_dtype`
("bfloat16" | "float32"), `inference_patch_size` and `device` (None means
"cuda"; the JAX package ignored this key).
"""

from __future__ import annotations

import abc
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.core.image import Image
from oai_analysis_2_tpu_torch.models.unet3d import UNet3D, get_network
from oai_analysis_2_tpu_torch.ops.tiling import Partition
from oai_analysis_2_tpu_torch.utils.checkpoint import (
    carry_params,
    convert_torch_unet_state_dict,
    load_checkpoint,
    load_torch_checkpoint,
)
from oai_analysis_2_tpu_torch.utils.config import load_json_to_dict


def _pad_indices(n: int, lo: int, hi: int, mode: str) -> np.ndarray:
    """Source index of every position of a dim of size `n` padded by
    (lo, hi), as `np.pad(mode="reflect")` picks it: mirrored about the end
    samples, the mirror repeated for pads of `n` or more (`F.pad` refuses
    those; the training tiling of a thin volume needs them)."""
    if mode != "reflect":
        raise ValueError(f"unsupported padding mode {mode!r}")
    i = np.arange(-lo, n + hi)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    m = np.mod(i, period)
    return np.where(m < n, m, period - m)


def _pad(volumes: torch.Tensor, pads, mode: str) -> torch.Tensor:
    """(B, D, H, W) padded on its three spatial dims by index gathers."""
    out = volumes
    for axis, (lo, hi) in enumerate(pads, start=1):
        idx = torch.as_tensor(_pad_indices(out.shape[axis], lo, hi, mode), device=volumes.device)
        out = out.index_select(axis, idx)
    return out


class Segmenter(abc.ABC):
    """Engine interface (port of `oai_analysis_2_tpu/engine/segmenter.py:36-41`,
    reference segmenter.py:19-35)."""

    @abc.abstractmethod
    def segment(self, image, *args, **kwargs):
        ...


class Segmenter3DInPatchClassWise(Segmenter):
    """Per-class sigmoid segmentation over overlap-tiled patches."""

    # Per-step conv budget in input voxels (tile voxels x batch x knees),
    # kept at the JAX package's value so the tile choice — and with it the
    # outputs inside the overlap shadow — match it exactly.
    STEP_VOXEL_BUDGET = 10_000_000

    def __init__(self, mode: str = "pred", config: Optional[dict] = None):
        self.mode = mode
        self.config = dict(config or {})
        self.device = resolve_device(self.config.get("device"))
        self.ready = False
        self.model: Optional[UNet3D] = None
        self.partition: Optional[Partition] = None
        self._auto_partitions = {}

    def pred_setup(self) -> None:
        """Load the training config and checkpoint and build the model."""
        training_config = load_json_to_dict(self.config["training_config_file"])
        self.patch_size = tuple(training_config["patch_size"])  # x, y, z
        spec = get_network(training_config["model"])
        self.pool_factor = 2 ** (len(spec.enc) - 1)
        ips = self.config.get("inference_patch_size")
        self.auto_tile = ips in (None, "auto")
        tile = self.patch_size if (self.auto_tile or ips == "train") else tuple(ips)
        if any(t % self.pool_factor for t in tile):
            raise ValueError(
                f"inference_patch_size {tile} must be divisible by {self.pool_factor} "
                f"(the {training_config['model']} pooling ladder)"
            )
        try:
            self.partition = Partition(tile, self.config.get("overlap_size", (16, 16, 8)), padding_mode="reflect")
        except ValueError:
            if not self.auto_tile:
                raise
            self.partition = None
        setting = dict(training_config.get("model_setting", {}))
        if "in_channel" in setting:
            setting["in_channels"] = setting.pop("in_channel")
        if "BN" in setting:
            setting["batchnorm"] = setting.pop("BN")
        spec = spec.replace(**{k: v for k, v in setting.items()
                               if k in ("in_channels", "n_classes", "bias", "batchnorm")})
        dtype = torch.bfloat16 if self.config.get("compute_dtype", "bfloat16") == "bfloat16" else torch.float32
        self.model = UNet3D(spec, compute_dtype=dtype, device=self.device)
        ckpt = self.config.get("ckpoint_path")
        if not ckpt or not Path(ckpt).is_file():
            raise ValueError(f"no checkpoint found at '{ckpt}'")
        if Path(ckpt).suffix == ".npz":
            state = load_checkpoint(ckpt)
            params = state["params"]
            self.epoch = int(state.get("epoch", 0))
            self.best_score = float(state.get("best_score", 0.0))
        else:  # the reference's torch checkpoint
            sd, self.epoch, self.best_score = load_torch_checkpoint(ckpt)
            params = convert_torch_unet_state_dict(sd, spec)
        carry_params(self.model, params)
        self.ready = True

    def partition_for(self, volume_shape: Tuple[int, int, int], n_knees: int = 1) -> Partition:
        """The tiling for one (z, y, x) volume shape (port of
        segmenter.py:132-169): auto z-slabs spanning x,y unless unsafe or
        not a win over the training tiling."""
        if not getattr(self, "auto_tile", False):
            return self.partition
        key = tuple(int(s) for s in volume_shape) + (int(n_knees),)
        if key not in self._auto_partitions:
            part = self._build_auto_partition(key[:3], n_knees) or self.partition
            if part is None:
                ov = tuple(self.config.get("overlap_size", (16, 16, 8)))
                raise ValueError(
                    f"no valid inference tiling for volume {key}: the training patch "
                    f"{self.patch_size} does not exceed 2x overlap {ov} and no auto z-slab qualified"
                )
            self._auto_partitions[key] = part
        return self._auto_partitions[key]

    def _build_auto_partition(self, volume_shape, n_knees: int = 1) -> Optional[Partition]:
        pool = self.pool_factor
        ov = tuple(self.config.get("overlap_size", (16, 16, 8)))  # x, y, z
        d, h, w = volume_shape

        def up(v: int) -> int:
            return -(-int(v) // pool) * pool

        tx = up(w + 2 * ov[0])
        ty = up(h + 2 * ov[1])
        tz = min(up(self.patch_size[2] + 2 * ov[2]), up(d + 2 * ov[2]))
        if tx * ty * tz * n_knees > self.STEP_VOXEL_BUDGET:
            return None
        if any(t - 2 * o <= 0 for t, o in zip((tx, ty, tz), ov)):
            return None
        cand = Partition((tx, ty, tz), ov, padding_mode="reflect")
        grid = cand.grid_shape(volume_shape)
        for e, g, o, s in zip(cand.effective_size, grid, cand.overlap_size, volume_shape):
            if o > s - 1 or (e * g + o - s) > s - 1:
                return None
        if self.partition is not None and cand.num_tiles(volume_shape) >= self.partition.num_tiles(volume_shape):
            return None
        return cand

    @classmethod
    def _step_batch(cls, batch_size: int, n_tiles: int, tile_voxels: int, n_knees: int) -> int:
        return max(1, min(batch_size, n_tiles, cls.STEP_VOXEL_BUDGET // (tile_voxels * n_knees)))

    def volume_fn_batched(self, n_knees: int, volume_shape: Tuple[int, int, int], batch_size: int,
                          threshold: bool):
        """volumes (B, D, H, W) f32 -> (B, C, D, H, W) probability maps. The
        JAX scan over tile batches is a Python loop writing each batch's
        central regions into a preallocated canvas."""
        partition = self.partition_for(volume_shape, n_knees)
        model = self.model
        n_classes = model.spec.n_classes
        eff = partition.effective_size
        ov = partition.overlap_size
        tz, ty, tx = partition.tile_size
        grid = partition.grid_shape(volume_shape)
        n_tiles = partition.num_tiles(volume_shape)
        batch_size = self._step_batch(batch_size, n_tiles, tz * ty * tx, n_knees)
        crop = tuple(self.config.get("overlap_size", (16, 16, 8)))
        padded_total = tuple(e * g + 2 * o for e, g, o in zip(eff, grid, ov))
        pads = [(o, pt - s - o) for o, pt, s in zip(ov, padded_total, volume_shape)]
        starts = [
            (i * eff[0], j * eff[1], k * eff[2])
            for i in range(grid[0]) for j in range(grid[1]) for k in range(grid[2])
        ]

        def run(volumes: torch.Tensor) -> torch.Tensor:
            padded = _pad(volumes, pads, partition.padding_mode)
            canvas = torch.zeros((n_knees, n_classes) + tuple(g * e for g, e in zip(grid, eff)),
                                 dtype=torch.float32, device=volumes.device)
            with torch.no_grad():
                for b0 in range(0, len(starts), batch_size):
                    batch = starts[b0 : b0 + batch_size]
                    tiles = torch.stack([padded[:, s[0] : s[0] + tz, s[1] : s[1] + ty, s[2] : s[2] + tx]
                                         for s in batch])
                    probs = torch.sigmoid(model(tiles.reshape(len(batch) * n_knees, tz, ty, tx, 1)))
                    if threshold:
                        probs = (probs > 0.5).to(torch.float32)
                    probs = probs.reshape(len(batch), n_knees, tz, ty, tx, n_classes)
                    central = probs[:, :, ov[0] : tz - ov[0], ov[1] : ty - ov[1], ov[2] : tx - ov[2], :]
                    for bi, s in enumerate(batch):
                        canvas[:, :, s[0] : s[0] + eff[0], s[1] : s[1] + eff[1], s[2] : s[2] + eff[2]] = (
                            central[bi].permute(0, 4, 1, 2, 3).to(torch.float32)
                        )
            out = canvas[:, :, : volume_shape[0], : volume_shape[1], : volume_shape[2]]
            # reference crop quirk: (cx, cy, cz) -> margins (cz, cx, cy) on (z, y, x)
            cz, cy_, cx_ = int(crop[2]), int(crop[0]), int(crop[1])
            mask = torch.zeros(volume_shape, dtype=out.dtype, device=out.device)
            mask[cz : volume_shape[0] - cz, cy_ : volume_shape[1] - cy_, cx_ : volume_shape[2] - cx_] = 1
            return out * mask[None, None]

        return run

    def segment(self, image, if_output_prob_map: bool = True, if_output_itk: bool = True):
        """Segment a preprocessed volume into (FC, TC) maps; Images when
        `if_output_itk` (metadata copied from the input), else tensors."""
        if not self.ready:
            self.pred_setup()
        if isinstance(image, Image):
            volume = image.data
        else:
            volume = image if torch.is_tensor(image) else torch.as_tensor(np.asarray(image))
        volume = volume.to(device=self.device, dtype=torch.float32)
        run = self.volume_fn_batched(1, tuple(volume.shape), int(self.config.get("batch_size", 4)),
                                     threshold=not if_output_prob_map)
        stacked = run(volume[None])[0]
        fc, tc = stacked[0], stacked[1]
        if if_output_itk and isinstance(image, Image):
            return image.with_data(fc), image.with_data(tc)
        return fc, tc

    def train(self, *args, **kwargs):
        """`engine.training.train_segmentation(*args, **kwargs)`, as the JAX
        package delegates (segmenter.py:357-362); pass `self.model` to
        train the model that `segment` serves."""
        from oai_analysis_2_tpu_torch.engine.training import train_segmentation

        return train_segmentation(*args, **kwargs)

    def test(self, pairs, threshold: float = 0.5) -> dict:
        """Dice of the loaded model on (image, label) pairs (port of
        `oai_analysis_2_tpu/engine/segmenter.py:364-386`): each image runs
        the production `segment` path; a label is (C, D, H, W) or a pair of
        per-class volumes. Returns per-volume [FC, TC] Dice and their mean."""
        results = []
        for image, label in pairs:
            fc, tc = self.segment(image, if_output_prob_map=True, if_output_itk=False)
            preds = [fc.cpu().numpy() > threshold, tc.cpu().numpy() > threshold]
            label = label.cpu().numpy() if torch.is_tensor(label) else np.asarray(label)
            labels = [label[c] for c in range(label.shape[0])] if label.ndim == 4 else list(label)
            dices = []
            for p, lab in zip(preds, labels):
                lab = np.asarray(lab) > 0.5
                denom = p.sum() + lab.sum()
                dices.append(float(2.0 * np.logical_and(p, lab).sum() / denom) if denom else 1.0)
            results.append(dices)
        arr = np.asarray(results, np.float64)
        return {"per_volume_dice": results, "mean_dice": arr.mean(axis=0).tolist()}
