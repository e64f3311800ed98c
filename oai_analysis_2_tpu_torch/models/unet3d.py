"""3D UNet family (port of `oai_analysis_2_tpu/models/unet3d.py`).

Activations are NDHWC and conv kernels DHWIO, as in the JAX package, and
parameters are named after the JAX parameter tree's paths (`enc0a.kernel`,
`dec1up.bias`, `head.kernel`, `enc0a.bn.mean`), so a JAX tree carries onto
the module one to one (`utils.checkpoint.carry_params`) and back
(`utils.checkpoint.export_params`). Every leaf of the JAX tree is a
parameter here, the batch-norm statistics too (JAX's `make_train_step`
differentiates the whole tree, so Adam trains them as well). Parameters
are created with `requires_grad=False`; a train step turns it on for the
model it trains, and every serving forward runs under `torch.no_grad()`.

Routing, as on the TPU's opt-in Pallas path but for every layer: each
3x3x3 conv goes through the hand-written kernel (`ops.cuda_conv.conv3d`,
bias + ReLU + cast fused); the k2s2 upconv and the 1x1x1 head are plain
f32 products (`torch.matmul`) of the compute-dtype operands, which the
JAX package leaves to XLA. A batch-norm spec (inference statistics, JAX
`unet3d.py:242-279`) puts BN between a block's conv and its ReLU: its
convs return the f32 accumulator plus bias (`relu=False,
out_dtype=torch.float32`), BN and ReLU run in f32, then one cast to the
compute dtype; the upconv gets BN before its ReLU too.

Training: `init(generator)` draws JAX's init (`unet3d.py:143-167`,
`:365-406`); whenever grad is enabled and the input or a conv's leaves
need a gradient, the 3x3x3 convs go through
`ops.cuda_conv.conv3d_train` (the same kernels under autograd), and
`forward(x, train=True)` on a BN spec normalizes with the batch's
statistics and also returns the updated running statistics (JAX
`_bn_train`, `apply(train=True)`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from oai_analysis_2_tpu_torch.core.device import ieee_f32_matmul, resolve_device
from oai_analysis_2_tpu_torch.ops.cuda_conv import conv3d, conv3d_train


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


def get_available_networks():
    return list(NETWORK_SPECS.keys())


def get_network(name: str) -> UNetSpec:
    if name not in NETWORK_SPECS:
        raise KeyError(f"Network {name} is not available! Choose from: {get_available_networks()}")
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


def make_threshold_params(model: Union["UNet3D", UNetSpec], gain: float = 24.0, threshold: float = 0.5) -> dict:
    """Numpy weights that make the UNet compute `sigmoid(gain * (x -
    threshold))` per class through the real topology (port of
    unet3d.py:285-332): identity taps input -> enc0a ch0 -> enc0b ch0 ->
    skip -> dec{last}a/b, and the threshold shift in the head bias.
    `model` is a `UNet3D`, as JAX's first argument, or its `UNetSpec`."""
    spec = model.spec if isinstance(model, UNet3D) else model
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


class _BatchNorm(nn.Module):
    """Batch norm of one block: the JAX tree's `bn` leaves (scale, bias and
    the running mean and var), all parameters."""

    def __init__(self, channels: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels, device=device), requires_grad=False)
        self.mean = nn.Parameter(torch.zeros(channels, device=device), requires_grad=False)
        self.var = nn.Parameter(torch.ones(channels, device=device), requires_grad=False)

    def forward(self, y: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        """(y - mean) * (rsqrt(var + eps) * scale) + bias, in f32 (JAX
        `_bn_inference`)."""
        inv = torch.rsqrt(self.var.to(torch.float32) + eps)
        return (y - self.mean) * (inv * self.scale) + self.bias

    def train_forward(self, y: torch.Tensor, eps: float = 1e-5, momentum: float = 0.1):
        """(normalized y, {"mean", "var"}) with the batch's statistics (JAX
        `_bn_train`): the biased variance normalizes, the unbiased one
        enters the running statistics (returned detached)."""
        mean = y.mean(dim=(0, 1, 2, 3))
        var = y.var(dim=(0, 1, 2, 3), unbiased=False)
        out = (y - mean) * (torch.rsqrt(var + eps) * self.scale) + self.bias
        n = y.numel() // y.shape[-1]
        unbiased = var * n / max(n - 1, 1)
        stats = {"mean": (1 - momentum) * self.mean + momentum * mean,
                 "var": (1 - momentum) * self.var + momentum * unbiased}
        return out, {k: v.detach() for k, v in stats.items()}


class _Block(nn.Module):
    """One conv's parameters, named like the JAX tree's leaves."""

    def __init__(self, kshape, bias_shape, device, batchnorm: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kshape, device=device), requires_grad=False)
        if bias_shape is not None:
            self.bias = nn.Parameter(torch.zeros(bias_shape, device=device), requires_grad=False)
        else:
            self.bias = None
        self.bn = _BatchNorm(kshape[-1], device) if batchnorm else None


def maxpool2x(x: torch.Tensor) -> torch.Tensor:
    """MaxPool3d(2) over NDHWC with floor semantics on odd dims."""
    n, d, h, w, c = x.shape
    d2, h2, w2 = d // 2, h // 2, w // 2
    x = x[:, : 2 * d2, : 2 * h2, : 2 * w2]
    return x.reshape(n, d2, 2, h2, 2, w2, 2, c).amax(dim=(2, 4, 6))


def _pointwise(x: torch.Tensor, blk: _Block) -> torch.Tensor:
    """1x1x1 conv as one f32 product of the compute-dtype operands, then
    the f32 bias: XLA's compiled JAX program keeps a bf16 conv's f32
    accumulator through its `astype(float32)`, so the product is not
    rounded to bf16 before the bias."""
    k = blk.kernel.to(x.dtype).to(torch.float32)
    with ieee_f32_matmul():
        y = x.to(torch.float32) @ k[0, 0, 0]
    if blk.bias is not None:
        y = y + blk.bias
    return y


def upconv2x(x: torch.Tensor, blk: _Block) -> torch.Tensor:
    """k2/s2 transposed conv as one f32 product (N*D*H*W, Cin) @ (Cin,
    8*Cout) of the compute-dtype operands, as `_pointwise`, with the JAX
    package's transpose order (unet3d.py:214-227)."""
    w = blk.kernel.to(x.dtype).to(torch.float32)
    n, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    wm = w.permute(3, 0, 1, 2, 4).reshape(cin, 8 * cout)
    with ieee_f32_matmul():
        y = x.to(torch.float32) @ wm
    y = y.reshape(n, d, h, wd, 2, 2, 2, cout)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(n, 2 * d, 2 * h, 2 * wd, cout)
    if blk.bias is not None:
        y = y + blk.bias
    return y


class UNet3D(nn.Module):
    """NDHWC -> NDHWC f32 logits. Parameters start at zero; draw JAX's init
    with `init` or carry weights with `utils.checkpoint.carry_params`."""

    def __init__(self, spec: UNetSpec, compute_dtype=torch.float32, device=None):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        dev = resolve_device(device)
        for name, leaves in param_shapes(spec).items():
            # every block but the 1x1x1 heads carries BN in a BN spec
            bn = spec.batchnorm and not name.startswith("head")
            self.add_module(name, _Block(leaves["kernel"], leaves.get("bias"), dev, batchnorm=bn))

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "UNet3D":
        """JAX's init (`unet3d.py:143-167`, `:365-406`): Xavier-normal
        kernels, std sqrt(2 / (fan_in + fan_out)) with fans k^3 * Cin and
        k^3 * Cout (the upconv's cur * 8 and cu * 8), zero biases, BN scale
        1, bias 0, mean 0, var 1. Draws come from `generator` (None: a CPU
        generator seeded with 0) in the JAX tree's block order, on the
        generator's device; the same distribution as JAX's, not the same
        values."""
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        for name, leaves in param_shapes(self.spec).items():
            blk = getattr(self, name)
            shape = leaves["kernel"]
            taps = shape[0] * shape[1] * shape[2]
            std = math.sqrt(2.0 / (taps * shape[3] + taps * shape[4]))
            blk.kernel.copy_(torch.randn(shape, generator=gen, device=gen.device) * std)
            if blk.bias is not None:
                blk.bias.zero_()
            if blk.bn is not None:
                for leaf, value in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0), ("var", 1.0)):
                    getattr(blk.bn, leaf).fill_(value)
        return self

    def _norm_relu(self, y: torch.Tensor, blk: _Block, name: str, stats: Optional[dict]) -> torch.Tensor:
        if blk.bn is None:
            return torch.relu(y)
        if stats is None:
            return torch.relu(blk.bn(y))
        y, stats[name] = blk.bn.train_forward(y)
        return torch.relu(y)

    def _conv(self, x: torch.Tensor, name: str, stats: Optional[dict], halo=None) -> torch.Tensor:
        if halo is not None:
            x, lo, hi = halo(x)
        blk = getattr(self, name)
        kernel = blk.kernel.to(x.dtype).contiguous()
        # a graph only where grad is enabled and something needs a gradient
        needs = x.requires_grad or kernel.requires_grad or (blk.bias is not None and blk.bias.requires_grad)
        conv = conv3d_train if torch.is_grad_enabled() and needs else conv3d
        if blk.bn is None:
            y = conv(x, kernel, blk.bias, relu=True, out_dtype=self.compute_dtype)
        else:
            y = conv(x, kernel, blk.bias, relu=False, out_dtype=torch.float32)
            y = self._norm_relu(y, blk, name, stats).to(self.compute_dtype)
        if halo is not None and (lo or hi):
            # the halo planes' outputs belong to the neighbours; the kernels
            # want a 16-byte aligned start, so the crop is copied
            y = y[:, lo : y.shape[1] - hi].contiguous()
        return y

    def forward(self, x: torch.Tensor, train: bool = False, halo=None):
        """x (N, D, H, W, Cin) -> f32 logits (N, D, H, W, n_classes); with
        `train` on a BN spec, (logits, {block: {"mean", "var"}}) with the
        batch's statistics (JAX `apply(train=True)`).

        `halo` (`parallel.sharding.ZHalo`): x is one z-block of a volume
        split over ranks; each 3x3x3 conv runs on the block with the
        neighbours' adjacent z-planes around it and keeps the block's own
        planes, so the logits are the block's share of the whole volume's.
        Max-pool and the upconv stay local, so D must divide by 2 ** (number
        of pools)."""
        spec = self.spec
        cd = self.compute_dtype
        stats = {} if train and spec.batchnorm else None
        if halo is not None:
            pools = 2 ** (len(spec.enc) - 1)
            if x.shape[1] % pools:
                raise ValueError(f"a z-block of depth {x.shape[1]} does not divide by {pools}, the UNet's pooling")
            if stats is not None:
                raise ValueError("train-mode batch norm takes its statistics from the whole batch; "
                                 "a z-sharded forward has only its block")
        x = x.to(cd).contiguous()
        skips = []
        for li in range(len(spec.enc)):
            x = self._conv(x, f"enc{li}a", stats, halo)
            x = self._conv(x, f"enc{li}b", stats, halo)
            if li < len(spec.enc) - 1:
                skips.append(x)
                x = maxpool2x(x).contiguous()
        for li in range(len(spec.dec)):
            name = f"dec{li}up"
            up = self._norm_relu(upconv2x(x, getattr(self, name)), getattr(self, name), name, stats)
            skip = skips[len(skips) - 1 - li]
            x = torch.cat([up.to(cd), skip.to(cd)], dim=-1)
            x = self._conv(x, f"dec{li}a", stats, halo)
            x = self._conv(x, f"dec{li}b", stats, halo)
        if spec.classwise_heads:
            logits = torch.cat(
                [_pointwise(x, getattr(self, f"head{c}")) for c in range(spec.n_classes)], dim=-1
            )
        else:
            logits = _pointwise(x, self.head)
        logits = logits.to(torch.float32)
        return (logits, stats) if stats is not None else logits
