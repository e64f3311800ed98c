"""GradICON registration network, forward pass only (port of
`oai_analysis_2_tpu/models/gradicon.py:43-387`).

Transforms live on a fixed registration grid in normalized [0, 1]^3
coordinates (z, y, x order); a map phi (D, H, W, 3) is the pullback
B_warped(x) = B(phi(x)). Stage k (coarse to fine) predicts an increment u
with a small f32 UNet and refines phi <- phi o (id + u). Training, the
losses and instance optimization are not ported yet (ROADMAP.md, Queue 1
item 10).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.models.unet3d import UNet3D, UNetSpec
from oai_analysis_2_tpu_torch.ops.resample import _trilinear_gather
from oai_analysis_2_tpu_torch.utils.checkpoint import carry_params, load_checkpoint


def identity_map(shape_zyx, device=None) -> torch.Tensor:
    """(D, H, W, 3) normalized coordinates of every voxel (the linspaces are
    formed in float64 and rounded once, as `_identity_map_np` does)."""
    axes = [torch.as_tensor(np.linspace(0.0, 1.0, int(s)).astype(np.float32), device=device)
            for s in shape_zyx]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([zz, yy, xx], dim=-1)


def _to_index(phi: torch.Tensor, shape_zyx) -> torch.Tensor:
    return phi * torch.as_tensor([s - 1.0 for s in shape_zyx], dtype=torch.float32, device=phi.device)


def warp(volume: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Pullback-warp a (D,H,W) volume: out(x) = volume(phi(x)). Outside -> 0."""
    return _trilinear_gather(volume, _to_index(phi, volume.shape), 0.0)


def compose(phi_outer: torch.Tensor, phi_inner: torch.Tensor) -> torch.Tensor:
    """(phi_outer o phi_inner)(x), inner points clamped to the unit cube."""
    pts = torch.clamp(phi_inner, 0.0, 1.0)
    return _trilinear_gather(phi_outer, _to_index(pts, phi_outer.shape[:3]), 0.0)


def downsample2x(volume: torch.Tensor) -> torch.Tensor:
    """2x average-pool of a (D,H,W) volume (VALID)."""
    d, h, w = (s // 2 for s in volume.shape)
    v = volume[: 2 * d, : 2 * h, : 2 * w].reshape(d, 2, h, 2, w, 2)
    return v.sum(dim=(1, 3, 5)) * 0.125


def resize_field(phi: torch.Tensor, shape_zyx) -> torch.Tensor:
    """Trilinear resize of a (D,H,W,3) normalized-coordinate field."""
    ident = identity_map(shape_zyx, phi.device)
    return _trilinear_gather(phi, _to_index(ident, phi.shape[:3]), 0.0)


def map_quality_stats(phi_ab: torch.Tensor, phi_ba: torch.Tensor) -> dict:
    """Inverse-consistency error (voxels, grid interior) and folded-Jacobian
    fractions (port of gradicon.py:195-235); values are 0-d tensors."""
    shape = phi_ab.shape[:3]
    vox = torch.as_tensor([s - 1.0 for s in shape], dtype=torch.float32, device=phi_ab.device)
    comp = compose(phi_ab, phi_ba)
    ice = (comp - identity_map(shape, phi_ab.device)) * vox
    ice_n = torch.sqrt(torch.sum(ice[2:-2, 2:-2, 2:-2] ** 2, dim=-1))

    def fold_fraction(phi):
        crop = (slice(0, shape[0] - 1), slice(0, shape[1] - 1), slice(0, shape[2] - 1))
        cols = [(torch.diff(phi, dim=j) * vox)[crop] for j in range(3)]
        det = torch.linalg.det(torch.stack(cols, dim=-1))
        return torch.mean((det <= 0.0).to(torch.float32))

    return {
        "ice_mean_vox": torch.mean(ice_n),
        "ice_max_vox": torch.max(ice_n),
        "fold_fraction_ab": fold_fraction(phi_ab),
        "fold_fraction_ba": fold_fraction(phi_ba),
    }


def _stage_spec(width: int = 16) -> UNetSpec:
    """A compact 3-level UNet: 2 image channels in, 3 displacement channels out."""
    w = width
    return UNetSpec(
        name="reg_stage",
        enc=((w, 2 * w), (2 * w, 4 * w), (4 * w, 8 * w)),
        dec=((8 * w, 4 * w, 4 * w), (4 * w, 2 * w, 2 * w)),
        in_channels=2,
        n_classes=3,
        bias=True,
        batchnorm=False,
    )


@dataclasses.dataclass(frozen=True)
class GradICONConfig:
    """The network's architecture and grid (the fields the forward pass and
    the shipped checkpoint's metadata use; training fields wait for the
    training port)."""

    grid_shape: Tuple[int, int, int] = (48, 96, 96)  # z, y, x
    scales: Tuple[int, ...] = (4, 2, 1)  # coarse-to-fine downsample factors
    stage_width: int = 16
    lncc_window: int = 5
    displacement_scale: float = 0.2


class GradICON(nn.Module):
    """Multiscale two-step registration network, one f32 UNet per scale."""

    def __init__(self, config: GradICONConfig = GradICONConfig(), device=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.stages = nn.ModuleList(
            UNet3D(_stage_spec(config.stage_width), torch.float32, dev) for _ in config.scales
        )

    def load_params(self, params_list: List[dict]) -> None:
        """Carry a JAX stage-params list onto the stage UNets."""
        carry_params(self, {"stages": {str(i): p for i, p in enumerate(params_list)}})

    def _stage_increment(self, stage: UNet3D, a_s, b_warp_s):
        net_in = torch.stack([a_s, b_warp_s], dim=-1)[None]
        u = stage(net_in)[0]
        return torch.tanh(u) * self.config.displacement_scale

    def forward_map(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """phi s.t. b(phi(x)) ~= a(x): the pullback warping B onto A's grid."""
        full_shape = tuple(a.shape)
        ident = identity_map(full_shape, a.device)
        phi = ident
        for stage, scale in zip(self.stages, self.config.scales):
            a_s, b_s = a, warp(b, phi)
            for _ in range(int.bit_length(scale) - 1):
                a_s, b_s = downsample2x(a_s), downsample2x(b_s)
            u = self._stage_increment(stage, a_s, b_s)
            if tuple(u.shape[:3]) != full_shape:
                u = resize_field(u, full_shape)
            phi = compose(phi, ident + u)
        return phi

    def both_maps(self, a: torch.Tensor, b: torch.Tensor):
        return self.forward_map(a, b), self.forward_map(b, a)


def default_gradicon_weights_path() -> Path:
    """The JAX package's shipped weights file, read as data by path."""
    return Path(__file__).resolve().parents[2] / "oai_analysis_2_tpu" / "weights" / "gradicon.npz"


def load_gradicon_checkpoint(path=None) -> Tuple[List[dict], dict]:
    """(stage-params list as numpy trees, architecture metadata)."""
    state = load_checkpoint(default_gradicon_weights_path() if path is None else path)
    stages = state["params"]
    meta = {}
    if "stage_width" in state:
        meta["stage_width"] = int(state["stage_width"])
    if "grid_shape" in state:
        meta["grid_shape"] = tuple(int(v) for v in state["grid_shape"])
    if "scales" in state:
        meta["scales"] = tuple(int(v) for v in state["scales"])
    return [stages[f"stage{i}"] for i in range(len(stages))], meta
