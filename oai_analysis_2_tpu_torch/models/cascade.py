"""Auto-context cascades of UNets (port of
`oai_analysis_2_tpu/models/cascade.py`).

Each stage after the first sees softmax(previous logits) concatenated with
the raw input and, with `residual`, adds its logits onto the running
prediction (the reference's `CascadedModel`, `AutoContextAsRNN` and
`UNet_light4x2`). Freezing earlier stages is the JAX way: the optimizer
holds only `trainable_params()`, so the other stages' parameters never get
their gradients turned on.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS, UNet3D, UNetSpec


class CascadedUNet(nn.Module):
    """A cascade of UNet3D stages with auto-context and residual wiring
    (cascade.py:23-65). Parameters are named `stages.<i>.<JAX leaf path>`."""

    def __init__(
        self,
        specs: Sequence[UNetSpec],
        auto_context: bool = True,
        residual: bool = True,
        residual_scale: float = 1.0,
        compute_dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.stages = nn.ModuleList(UNet3D(s, compute_dtype, dev) for s in specs)
        self.auto_context = auto_context
        self.residual = residual
        self.residual_scale = residual_scale

    def init(self, generator: Optional[torch.Generator] = None) -> "CascadedUNet":
        """Every stage's UNet init, drawn in turn from `generator`."""
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        for stage in self.stages:
            stage.init(gen)
        return self

    def forward(self, x: torch.Tensor, multi_output: bool = False):
        """x (N, D, H, W, C_in) -> the final logits, or every stage's running
        logits with `multi_output`."""
        out = self.stages[0](x)
        outputs = [out]
        for stage in self.stages[1:]:
            if self.auto_context:
                stage_in = torch.cat([torch.softmax(out, dim=-1).to(x.dtype), x], dim=-1)
            else:
                stage_in = x
            stage_out = stage(stage_in)
            out = stage_out * self.residual_scale + out if self.residual else stage_out
            outputs.append(out)
        return outputs if multi_output else out

    def trainable_params(self, end2end: bool = False) -> List[nn.Parameter]:
        """The parameters to optimize: the last stage's unless `end2end`
        (the reference trains only the last stage, networks.py:749-754)."""
        stages = self.stages if end2end else self.stages[-1:]
        return [p for stage in stages for p in stage.parameters()]


def auto_context_step(
    model: UNet3D,
    x: torch.Tensor,
    hidden: torch.Tensor,
    residual: int = 0,
    residual_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent auto-context iteration (cascade.py:68-82): concat(x,
    softmax(hidden)) -> the UNet -> the new hidden state (added onto the old
    one with `residual`); returns (softmax(new hidden), new hidden). JAX's
    `params` argument is the model's own parameters here."""
    combined = torch.cat([x, torch.softmax(hidden, dim=-1).to(x.dtype)], dim=-1)
    delta = model(combined)
    new_hidden = hidden + delta * residual_scale if residual else delta
    return torch.softmax(new_hidden, dim=-1), new_hidden


def init_hidden(shape, n_classes: int, device=None) -> torch.Tensor:
    """Uniform 0.5 initial hidden state, shape + (n_classes,) f32."""
    return torch.full(tuple(shape) + (n_classes,), 0.5, dtype=torch.float32, device=resolve_device(device))


def make_unet_light4x2(
    in_channels: int = 1, n_classes: int = 2, bias: bool = False, BN: bool = False,
    compute_dtype=torch.float32, device=None,
) -> CascadedUNet:
    """The reference's UNet_light4x2 (cascade.py:90-102): two light4-shaped
    stages; stage 2 sees softmax(stage 1) ++ input and adds its logits onto
    stage 1's."""
    s1 = NETWORK_SPECS["UNet_light4"].replace(in_channels=in_channels, n_classes=n_classes, bias=bias, batchnorm=BN)
    s2 = s1.replace(in_channels=in_channels + n_classes)
    return CascadedUNet([s1, s2], auto_context=True, residual=True, residual_scale=1.0,
                        compute_dtype=compute_dtype, device=device)
