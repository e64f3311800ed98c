"""3D UNet family (port of `oai_analysis_2_tpu/models/unet3d.py`).

Inference only. Activations are NDHWC and conv kernels DHWIO, as in the
JAX package, and parameters are named after the JAX parameter tree's paths
(`enc0a.kernel`, `dec1up.bias`, `head.kernel`), so a JAX tree carries onto
the module one to one (`utils.checkpoint.carry_params`).

Routing, as on the TPU's opt-in Pallas path but for every layer: each
3x3x3 conv goes through the hand-written kernel (`ops.cuda_conv.conv3d`,
bias + ReLU + cast fused); the k2s2 upconv and the 1x1x1 head are plain
products (`torch.matmul`), which the JAX package leaves to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.ops.cuda_conv import conv3d


@dataclasses.dataclass(frozen=True)
class UNetSpec:
    """Static architecture description of one UNet variant.

    enc:  per resolution level, the output channels of the two encoder convs.
    dec:  per decoder level from deepest to shallowest:
          (upconv_out, conv1_out, conv2_out); conv1 consumes
          upconv_out + skip channels.
    """

    name: str
    enc: Tuple[Tuple[int, int], ...]
    dec: Tuple[Tuple[int, int, int], ...]
    in_channels: int = 1
    n_classes: int = 2
    bias: bool = False
    batchnorm: bool = False
    classwise_heads: bool = False

    @property
    def head_in(self) -> int:
        return self.dec[-1][2]

    def replace(self, **kw) -> "UNetSpec":
        return dataclasses.replace(self, **kw)


def _spec(name, enc, dec, **kw):
    return UNetSpec(name=name, enc=tuple(map(tuple, enc)), dec=tuple(map(tuple, dec)), **kw)


# Channel tables copied from oai_analysis_2_tpu/models/unet3d.py:80-124.
NETWORK_SPECS: Dict[str, UNetSpec] = {
    "UNet": _spec(
        "UNet",
        enc=[(32, 64), (64, 128), (128, 256), (256, 512)],
        dec=[(512, 256, 256), (256, 128, 128), (128, 64, 64)],
    ),
    "UNetClassWise": _spec(
        "UNetClassWise",
        enc=[(32, 64), (64, 128), (128, 256), (256, 512)],
        dec=[(512, 256, 256), (256, 128, 128), (128, 64, 64)],
        classwise_heads=True,
    ),
    "UNet_light1": _spec("UNet_light1", enc=[(16, 32), (32, 64), (64, 128)], dec=[(128, 64, 64), (64, 32, 32)]),
    "UNet_light2": _spec("UNet_light2", enc=[(8, 16), (16, 32), (32, 64)], dec=[(64, 32, 32), (32, 16, 16)]),
    "UNet_light3": _spec("UNet_light3", enc=[(8, 16), (16, 32), (32, 32)], dec=[(32, 32, 32), (16, 16, 8)]),
    "UNet_light4": _spec("UNet_light4", enc=[(8, 16), (16, 32)], dec=[(16, 16, 8)]),
    "UNet_light4_2": _spec("UNet_light4_2", enc=[(8, 16), (16, 32)], dec=[(32, 16, 8)]),
}


def get_network(name: str) -> UNetSpec:
    if name not in NETWORK_SPECS:
        raise KeyError(f"Network {name} is not available! Choose from: {list(NETWORK_SPECS)}")
    return NETWORK_SPECS[name]


def param_shapes(spec: UNetSpec) -> Dict[str, Dict[str, tuple]]:
    """{block name: {"kernel": shape[, "bias": shape]}} — the JAX `init`
    tree's structure (unet3d.py:365-404), computed from the spec."""
    shapes: Dict[str, Dict[str, tuple]] = {}

    def block(name, kshape):
        shapes[name] = {"kernel": tuple(kshape)}
        if spec.bias:
            shapes[name]["bias"] = (kshape[-1],)

    cin = spec.in_channels
    for li, (ca, cb) in enumerate(spec.enc):
        block(f"enc{li}a", (3, 3, 3, cin, ca))
        block(f"enc{li}b", (3, 3, 3, ca, cb))
        cin = cb
    cur = spec.enc[-1][1]
    for li, (cu, c1, c2) in enumerate(spec.dec):
        skip = spec.enc[len(spec.enc) - 2 - li][1]
        block(f"dec{li}up", (2, 2, 2, cur, cu))
        block(f"dec{li}a", (3, 3, 3, cu + skip, c1))
        block(f"dec{li}b", (3, 3, 3, c1, c2))
        cur = c2
    if spec.classwise_heads:
        for c in range(spec.n_classes):
            block(f"head{c}", (1, 1, 1, spec.head_in, 1))
    else:
        block("head", (1, 1, 1, spec.head_in, spec.n_classes))
    return shapes


def make_threshold_params(spec: UNetSpec, gain: float = 24.0, threshold: float = 0.5) -> dict:
    """Numpy weights that make the UNet compute `sigmoid(gain * (x -
    threshold))` per class through the real topology (port of
    unet3d.py:285-332): identity taps input -> enc0a ch0 -> enc0b ch0 ->
    skip -> dec{last}a/b, and the threshold shift in the head bias."""
    if not spec.bias:
        raise ValueError("threshold params need spec.bias=True for the shift")
    params = {
        name: {k: np.zeros(s, np.float32) for k, s in leaves.items()}
        for name, leaves in param_shapes(spec).items()
    }

    def center_tap(p, cin_idx, cout_idx):
        c = p["kernel"].shape[0] // 2
        p["kernel"][c, c, c, cin_idx, cout_idx] = 1.0

    center_tap(params["enc0a"], 0, 0)
    center_tap(params["enc0b"], 0, 0)
    last = len(spec.dec) - 1
    up_ch = spec.dec[last][0]
    center_tap(params[f"dec{last}a"], up_ch + 0, 0)
    center_tap(params[f"dec{last}b"], 0, 0)
    heads = [f"head{c}" for c in range(spec.n_classes)] if spec.classwise_heads else ["head"]
    for name in heads:
        p = params[name]
        p["kernel"][0, 0, 0, 0, :] = gain
        p["bias"] = p["bias"] + np.float32(-gain * threshold)
    return params


class _Block(nn.Module):
    """One conv's parameters, named like the JAX tree's leaves."""

    def __init__(self, kshape, bias_shape, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kshape, device=device), requires_grad=False)
        if bias_shape is not None:
            self.bias = nn.Parameter(torch.zeros(bias_shape, device=device), requires_grad=False)
        else:
            self.bias = None


def maxpool2x(x: torch.Tensor) -> torch.Tensor:
    """MaxPool3d(2) over NDHWC with floor semantics on odd dims."""
    n, d, h, w, c = x.shape
    d2, h2, w2 = d // 2, h // 2, w // 2
    x = x[:, : 2 * d2, : 2 * h2, : 2 * w2]
    return x.reshape(n, d2, 2, h2, 2, w2, 2, c).amax(dim=(2, 4, 6))


def _pointwise(x: torch.Tensor, blk: _Block) -> torch.Tensor:
    """1x1x1 conv as one product in the compute dtype (the JAX path's bf16
    conv output is rounded to bf16 before the f32 bias)."""
    k = blk.kernel.to(x.dtype)
    y = (x @ k[0, 0, 0]).to(torch.float32)
    if blk.bias is not None:
        y = y + blk.bias
    return y


def upconv2x(x: torch.Tensor, blk: _Block) -> torch.Tensor:
    """k2/s2 transposed conv as one product (N*D*H*W, Cin) @ (Cin, 8*Cout)
    with the JAX package's transpose order (unet3d.py:214-227)."""
    w = blk.kernel.to(x.dtype)
    n, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    wm = w.permute(3, 0, 1, 2, 4).reshape(cin, 8 * cout)
    y = (x @ wm).to(torch.float32)
    y = y.reshape(n, d, h, wd, 2, 2, 2, cout)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(n, 2 * d, 2 * h, 2 * wd, cout)
    if blk.bias is not None:
        y = y + blk.bias
    return y


class UNet3D(nn.Module):
    """NDHWC -> NDHWC f32 logits. Parameters start at zero; carry weights
    with `utils.checkpoint.carry_params`."""

    def __init__(self, spec: UNetSpec, compute_dtype=torch.float32, device=None):
        super().__init__()
        if spec.batchnorm:
            raise NotImplementedError("batch-norm UNet specs are not ported yet")
        self.spec = spec
        self.compute_dtype = compute_dtype
        dev = resolve_device(device)
        for name, leaves in param_shapes(spec).items():
            self.add_module(name, _Block(leaves["kernel"], leaves.get("bias"), dev))

    def _conv(self, x: torch.Tensor, name: str) -> torch.Tensor:
        blk = getattr(self, name)
        return conv3d(x, blk.kernel.to(x.dtype).contiguous(), blk.bias, relu=True, out_dtype=self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        cd = self.compute_dtype
        x = x.to(cd).contiguous()
        skips = []
        for li in range(len(spec.enc)):
            x = self._conv(x, f"enc{li}a")
            x = self._conv(x, f"enc{li}b")
            if li < len(spec.enc) - 1:
                skips.append(x)
                x = maxpool2x(x).contiguous()
        for li in range(len(spec.dec)):
            up = torch.relu(upconv2x(x, getattr(self, f"dec{li}up")))
            skip = skips[len(skips) - 1 - li]
            x = torch.cat([up.to(cd), skip.to(cd)], dim=-1)
            x = self._conv(x, f"dec{li}a")
            x = self._conv(x, f"dec{li}b")
        if spec.classwise_heads:
            logits = torch.cat(
                [_pointwise(x, getattr(self, f"head{c}")) for c in range(spec.n_classes)], dim=-1
            )
        else:
            logits = _pointwise(x, self.head)
        return logits.to(torch.float32)
