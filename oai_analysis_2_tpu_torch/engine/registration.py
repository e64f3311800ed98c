"""Registration engine, network mode (port of
`oai_analysis_2_tpu/engine/registration.py`).

Images are resampled onto a fixed registration grid spanning each image's
physical extent, registered with the trained GradICON network, and the
result is returned as a physical-space `DisplacementField`:
`register(image_A, image_B)` gives the transform that pulls A-grid data
(probability maps) onto B's (atlas) grid.

Instance optimization and network fine-tuning need autograd through the
conv kernel and an optimizer; they are not ported yet (ROADMAP.md, Queue 1
item 10) and raise NotImplementedError instead of falling back.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.core.image import Image
from oai_analysis_2_tpu_torch.models.gradicon import (
    GradICON,
    GradICONConfig,
    default_gradicon_weights_path,
    identity_map,
    load_gradicon_checkpoint,
    map_quality_stats,
)
from oai_analysis_2_tpu_torch.ops.resample import DisplacementField, resample_image

_NOT_PORTED = (
    "instance optimization and network fine-tuning are not ported to the "
    "PyTorch package yet (ROADMAP.md, Queue 1 item 10)"
)


def _net_grid_reference(image: Image, grid_shape_zyx) -> Image:
    """The registration grid over `image`'s physical extent: same origin and
    direction, spacing scaled so the grid's corners are the volume's."""
    src = np.asarray(image.shape, np.float64)
    dst = np.asarray(grid_shape_zyx, np.float64)
    spacing_zyx = image.spacing.detach().cpu().numpy()[::-1] * (src - 1.0) / (dst - 1.0)
    dev = image.device
    return Image(
        data=torch.zeros(tuple(int(s) for s in grid_shape_zyx), dtype=torch.float32, device=dev),
        origin=image.origin,
        spacing=torch.as_tensor(spacing_zyx[::-1].astype(np.float32), device=dev),
        direction=image.direction,
    )


def _normalized_to_physical(grid: Image, phi_zyx: torch.Tensor) -> torch.Tensor:
    shape = torch.as_tensor(np.asarray(grid.shape, np.float32) - 1.0, device=phi_zyx.device)
    return grid.indices_to_physical((phi_zyx * shape).flip(-1))


def _maps_to_displacement(phi_ba: torch.Tensor, grid_a: Image, grid_b: Image) -> DisplacementField:
    """The normalized map phi_BA (B-grid coords -> A-grid coords) as a
    physical displacement field on B's grid."""
    p_b = _normalized_to_physical(grid_b, identity_map(grid_b.shape, phi_ba.device))
    p_a = _normalized_to_physical(grid_a, phi_ba)
    return DisplacementField(field=(p_a - p_b).to(torch.float32), origin=grid_b.origin,
                             spacing=grid_b.spacing, direction=grid_b.direction)


def register_pair(
    image_a: Image,
    image_b: Image,
    model: GradICON,
    config: Optional[GradICONConfig] = None,
    finetune_steps: int = 0,
    b_on_grid: Optional[torch.Tensor] = None,
    quality_out: Optional[dict] = None,
) -> Tuple[DisplacementField, DisplacementField]:
    """(phi_AB, phi_BA) as displacement fields from one network forward
    pass; phi_AB pulls A-grid data onto B's grid. `b_on_grid` is image_b
    already resampled onto its registration grid (the atlas cache).
    `quality_out` receives the inverse-consistency error (voxels and mm)
    and folded-Jacobian fractions as 0-d tensors."""
    if finetune_steps:
        raise NotImplementedError(_NOT_PORTED)
    cfg = config or model.config
    grid_a = _net_grid_reference(image_a, cfg.grid_shape)
    grid_b = _net_grid_reference(image_b, cfg.grid_shape)
    a = resample_image(image_a, grid_a).data.to(torch.float32)
    b = b_on_grid if b_on_grid is not None else resample_image(image_b, grid_b).data.to(torch.float32)
    with torch.no_grad():
        nmap_ab, nmap_ba = model.both_maps(a, b)
        if quality_out is not None:
            q = map_quality_stats(nmap_ab, nmap_ba)
            pitch = float(np.mean(grid_a.spacing.detach().cpu().numpy()))
            quality_out.update(q)
            quality_out["ice_mean_mm"] = q["ice_mean_vox"] * pitch
            quality_out["ice_max_mm"] = q["ice_max_vox"] * pitch
        disp_ab_on_b = _maps_to_displacement(nmap_ba, grid_a, grid_b)
        disp_ba_on_a = _maps_to_displacement(nmap_ab, grid_b, grid_a)
    return disp_ab_on_b, disp_ba_on_a


class ICON_Registration:
    """API-parity facade (reference registration.py:18-27), network mode.

    mode "auto" resolves to "network" when the shipped GradICON weights
    exist and match the config (with no config given, the checkpoint's own
    metadata defines it); otherwise, and for mode "instance" or
    `finetune_steps > 0`, it raises NotImplementedError."""

    def __init__(
        self,
        mode: str = "auto",
        config: Optional[GradICONConfig] = None,
        finetune_steps: int = 0,
        collect_quality: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        if config is None and mode in ("auto", "network"):
            config = self._config_from_shipped_meta()
        self.config = config or GradICONConfig()
        if finetune_steps:
            raise NotImplementedError(_NOT_PORTED)
        self.finetune_steps = finetune_steps
        self.collect_quality = collect_quality
        self.params: Optional[List[dict]] = None
        self._last_quality_dev: Optional[dict] = None
        self._moving_on_grid_cache: dict = {}

        need = max(self.config.scales) * 4
        grid_ok = all(s % need == 0 for s in self.config.grid_shape)
        if mode == "auto":
            if not (grid_ok and self._try_load_default()):
                raise NotImplementedError(
                    "registration mode 'auto' found no matching shipped GradICON weights and would "
                    f"resolve to instance optimization: {_NOT_PORTED}"
                )
            mode = "network"
            warnings.warn(
                "registration mode 'auto' resolved to the shipped synthetic-trained GradICON network",
                stacklevel=2,
            )
        if mode == "instance":
            raise NotImplementedError(_NOT_PORTED)
        if mode != "network":
            raise ValueError(f"unknown registration mode {mode!r}")
        if not grid_ok:
            raise ValueError(f"network mode needs grid_shape divisible by {need}, got {self.config.grid_shape}")
        self.mode = mode
        self.model = GradICON(self.config, device=self.device)
        if self.params is None and default_gradicon_weights_path().exists():
            self.params, _ = load_gradicon_checkpoint()
        if self.params is not None:
            self.model.load_params(self.params)

    @staticmethod
    def _config_from_shipped_meta() -> Optional[GradICONConfig]:
        if not default_gradicon_weights_path().exists():
            return None
        _, meta = load_gradicon_checkpoint()
        if not meta:
            return None
        fields = {f.name for f in dataclasses.fields(GradICONConfig)}
        return GradICONConfig(**{k: v for k, v in meta.items() if k in fields})

    def _try_load_default(self) -> bool:
        """Load the shipped weights iff they exist and match the config's
        stage count and width."""
        if not default_gradicon_weights_path().exists():
            return False
        params, _ = load_gradicon_checkpoint()
        if len(params) != len(self.config.scales):
            return False
        if int(params[0]["enc0a"]["kernel"].shape[-1]) != self.config.stage_width:
            return False
        self.params = params
        return True

    def load_params(self, params: List[dict]) -> None:
        self.params = params
        self.model.load_params(params)

    def register(self, fixed_image: Image, moving_image: Image) -> DisplacementField:
        """The transform that pulls fixed-grid data onto the moving (atlas)
        grid. The moving image resampled onto its registration grid is
        cached (the atlas is fixed across a cohort)."""
        if self.params is None:
            raise ValueError("network-mode registration without weights: call load_params()")
        key = (
            id(moving_image.data),
            tuple(moving_image.shape),
            moving_image.origin.cpu().numpy().tobytes(),
            moving_image.spacing.cpu().numpy().tobytes(),
            moving_image.direction.cpu().numpy().tobytes(),
            tuple(self.config.grid_shape),
        )
        cached = self._moving_on_grid_cache.get(key)
        if cached is None:
            grid_b = _net_grid_reference(moving_image, self.config.grid_shape)
            b_on_grid = resample_image(moving_image, grid_b).data.to(torch.float32)
            if len(self._moving_on_grid_cache) >= 4:
                self._moving_on_grid_cache.clear()
            # the entry keeps the source alive, so its id() stays valid
            self._moving_on_grid_cache[key] = (moving_image.data, b_on_grid)
        else:
            _, b_on_grid = cached
        quality: Optional[dict] = {} if self.collect_quality else None
        phi_ab, _ = register_pair(
            fixed_image, moving_image, self.model, self.config,
            b_on_grid=b_on_grid, quality_out=quality,
        )
        self._last_quality_dev = quality
        return phi_ab

    @property
    def last_quality(self) -> Optional[dict]:
        """Quality metrics of the latest register() call as floats."""
        q = self._last_quality_dev
        if not q:
            return None
        return {k: round(float(v), 6) for k, v in q.items()}
