"""Registration engine (port of `oai_analysis_2_tpu/engine/registration.py`).

Images are resampled onto a fixed registration grid spanning each image's
physical extent and registered there, by the trained GradICON network
(optionally refined by per-pair fine-tuning steps) or by instance
optimization with no weights at all; the result is returned as a
physical-space `DisplacementField`: `register(image_A, image_B)` gives the
transform that pulls A-grid data (probability maps) onto B's (atlas) grid.
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
    INSTANCE_DEFAULT_GICON_GRAD,
    GradICON,
    GradICONConfig,
    default_gradicon_weights_path,
    identity_map,
    load_gradicon_checkpoint,
    map_quality_stats,
    register_pair_instance,
)
from oai_analysis_2_tpu_torch.ops.resample import DisplacementField, resample_image


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
    model: Optional[GradICON] = None,
    config: Optional[GradICONConfig] = None,
    instance_steps=(80, 60, 40),
    instance_scales: Tuple[int, ...] = (4, 2, 1),
    lambda_reg: float = 0.5,
    diffusion_weight: float = 0.3,
    finetune_steps: int = 0,
    finetune_scales: Tuple[int, ...] = (2,),
    finetune_lr: float = 0.15,
    b_on_grid: Optional[torch.Tensor] = None,
    gicon_grad: Optional[str] = None,
    early_stop: Optional[float] = None,
    quality_out: Optional[dict] = None,
) -> Tuple[DisplacementField, DisplacementField]:
    """(phi_AB, phi_BA) as displacement fields; phi_AB pulls A-grid data onto
    B's grid (port of registration.py:131-244).

    With `model` (weights loaded): one network forward pass, then
    `finetune_steps` of instance optimization per scale in
    `finetune_scales` at `finetune_lr`, starting from the network's maps.
    Without: instance optimization from the identity (`instance_scales`,
    `instance_steps`). `b_on_grid` is image_b already resampled onto its
    registration grid (the atlas cache). `gicon_grad` (None: the package
    default) and `early_stop` are `register_pair_instance`'s. `quality_out`
    receives the inverse-consistency error (voxels and mm) and
    folded-Jacobian fractions as 0-d tensors."""
    gicon_grad = INSTANCE_DEFAULT_GICON_GRAD if gicon_grad is None else gicon_grad
    cfg = config or (model.config if model is not None else GradICONConfig())
    grid_a = _net_grid_reference(image_a, cfg.grid_shape)
    grid_b = _net_grid_reference(image_b, cfg.grid_shape)
    a = resample_image(image_a, grid_a).data.to(torch.float32)
    b = b_on_grid if b_on_grid is not None else resample_image(image_b, grid_b).data.to(torch.float32)
    common = dict(lncc_window=cfg.lncc_window, lambda_reg=lambda_reg, diffusion_weight=diffusion_weight,
                  gicon_grad=gicon_grad, early_stop=early_stop)
    if model is not None:
        with torch.no_grad():
            nmap_ab, nmap_ba = model.both_maps(a, b)
        if finetune_steps:
            # a good network init needs far smaller steps than a cold start
            nmap_ab, nmap_ba = register_pair_instance(
                a, b, scales=finetune_scales, steps_per_scale=finetune_steps, lr=finetune_lr,
                init_ab=nmap_ab, init_ba=nmap_ba, **common,
            )
    else:
        nmap_ab, nmap_ba = register_pair_instance(
            a, b, scales=instance_scales, steps_per_scale=instance_steps, **common,
        )
    with torch.no_grad():
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
    """API-parity facade (reference registration.py:18-27).

    Modes:
      * "auto": "network" when the shipped GradICON weights exist and match
        the config (with no config given, the checkpoint's own metadata
        defines it), with a warning; else "instance";
      * "network": the trained network (+ `finetune_steps` of per-pair
        refinement); registering without weights raises;
      * "instance": per-pair optimization, no weights needed.
    """

    def __init__(
        self,
        mode: str = "auto",
        config: Optional[GradICONConfig] = None,
        instance_steps=(80, 60, 40),
        instance_scales: Tuple[int, ...] = (4, 2, 1),
        finetune_steps: int = 0,
        finetune_scales: Tuple[int, ...] = (2,),
        finetune_lr: float = 0.15,
        verbose: bool = False,
        gicon_grad: Optional[str] = None,
        early_stop: Optional[float] = None,
        collect_quality: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        if config is None and mode in ("auto", "network"):
            config = self._config_from_shipped_meta()
        self.config = config or GradICONConfig()
        self.instance_steps = instance_steps
        self.instance_scales = instance_scales
        self.finetune_steps = finetune_steps
        self.finetune_scales = finetune_scales
        self.finetune_lr = finetune_lr
        self.verbose = verbose
        self.gicon_grad = gicon_grad
        self.early_stop = early_stop
        self.collect_quality = collect_quality
        self.model: Optional[GradICON] = None
        self.params: Optional[List[dict]] = None
        self._last_quality_dev: Optional[dict] = None
        self._moving_on_grid_cache: dict = {}

        # the stage UNets (two 2x pools) need every grid dim divisible by
        # max_scale * 4; instance mode has no such constraint
        need = max(self.config.scales) * 4
        grid_ok = all(s % need == 0 for s in self.config.grid_shape)
        if mode == "auto":
            mode = "network" if grid_ok and self._try_load_default() else "instance"
            if mode == "network":
                warnings.warn(
                    "registration mode 'auto' resolved to the shipped synthetic-trained GradICON "
                    "network; pass mode='instance' for per-pair optimization",
                    stacklevel=2,
                )
        self.mode = mode
        if mode == "network":
            if not grid_ok:
                raise ValueError(f"network mode needs grid_shape divisible by {need}, got {self.config.grid_shape}")
            self.model = GradICON(self.config, device=self.device)
            if self.params is None and default_gradicon_weights_path().exists():
                self.params, _ = load_gradicon_checkpoint()
            if self.params is not None:
                self.model.load_params(self.params)
        elif mode != "instance":
            raise ValueError(f"unknown registration mode {mode!r}")

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
        if self.model is not None:
            self.model.load_params(params)

    def register(self, fixed_image: Image, moving_image: Image) -> DisplacementField:
        """The transform that pulls fixed-grid data onto the moving (atlas)
        grid. The moving image resampled onto its registration grid is
        cached (the atlas is fixed across a cohort)."""
        if self.mode == "network" and self.params is None:
            raise ValueError("network-mode registration without weights: call load_params()")
        if self.verbose:
            print("fixed range", float(fixed_image.data.min()), float(fixed_image.data.max()))
            print("moving range", float(moving_image.data.min()), float(moving_image.data.max()))
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
            fixed_image, moving_image,
            model=self.model if self.mode == "network" else None,
            config=self.config,
            instance_steps=self.instance_steps,
            instance_scales=self.instance_scales,
            finetune_steps=self.finetune_steps,
            finetune_scales=self.finetune_scales,
            finetune_lr=self.finetune_lr,
            b_on_grid=b_on_grid,
            gicon_grad=self.gicon_grad,
            early_stop=self.early_stop,
            quality_out=quality,
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
