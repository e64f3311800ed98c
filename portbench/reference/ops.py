"""Plain building blocks of the reference: precision control, trilinear
gathers, the GradICON map algebra and losses, a UNet forward through
`F.conv3d`, and Optax's Adam. Plain PyTorch only; nothing of the program.

Maps live on a registration grid in normalized [0, 1]^3 coordinates (z, y,
x); a map phi (D, H, W, 3) is the pullback B_warped(x) = B(phi(x)).
Activations are NDHWC and kernels DHWIO, as the weights files store them.

Precision: `Precision(name)` rounds operands and results to the named
type and computes in f32 with TF32 off: "float32", "bfloat16", "float8"
(e4m3), or "tf32" (f32 operands, convs and products on the tensor cores'
TF32). The reference runs at the configuration's precision; the control
runs it one step below.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F


class Precision:
    """Where a computation rounds, and whether its products use TF32."""

    ROUND = {"float32": None, "tf32": None, "bfloat16": torch.bfloat16, "float8": torch.float8_e4m3fn}

    def __init__(self, name: str):
        if name not in self.ROUND:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = self.ROUND[name]

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """x rounded to the precision's type, returned in f32; under autograd
        the gradient is rounded the same way, as a cast rounds it."""
        if self.dtype is None:
            return x.to(torch.float32)
        if x.requires_grad:
            return _Round.apply(x, self.dtype)
        return x.to(self.dtype).to(torch.float32)

    @contextlib.contextmanager
    def products(self):
        """TF32 on for "tf32", off otherwise, restored afterwards."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.to(dtype).to(torch.float32)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype).to(torch.float32), None



# ---------------------------------------------------------------------------
# Gathers
# ---------------------------------------------------------------------------


class _ClipTies(torch.autograd.Function):
    """clamp whose gradient is halved where x sits on a bound (a max then a
    min, each splitting a tie's gradient in two)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = ((x > lo) & (x < hi)).to(grad.dtype)
        ties = ((x == lo) | (x == hi)).to(grad.dtype)
        return grad * (inside + 0.5 * ties), None, None


def clip_ties(x, lo: float, hi: float):
    return _ClipTies.apply(x, lo, hi)


def _lerp(a, b, f):
    return a * (1 - f) + b * f


def gather(volume: torch.Tensor, idx: torch.Tensor, outside: float = 0.0, z_first: bool = False):
    """Trilinear sample of a (D, H, W[, C]) volume at continuous (..., 3)
    z, y, x indices: points more than 1e-3 outside the buffer give
    `outside`, taps are clamped to it. `z_first` blends along z first."""
    d, h, w = volume.shape[:3]
    z, y, x = idx[..., 0], idx[..., 1], idx[..., 2]
    eps = 1e-3
    inside = ((z >= -eps) & (z <= d - 1.0 + eps) & (y >= -eps) & (y <= h - 1.0 + eps)
              & (x >= -eps) & (x <= w - 1.0 + eps))
    z0 = torch.clamp(torch.floor(z), 0, d - 1).long()
    y0 = torch.clamp(torch.floor(y), 0, h - 1).long()
    x0 = torch.clamp(torch.floor(x), 0, w - 1).long()
    z1, y1, x1 = torch.clamp(z0 + 1, max=d - 1), torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    fz = clip_ties(z - z0.to(z.dtype), 0.0, 1.0)
    fy = clip_ties(y - y0.to(y.dtype), 0.0, 1.0)
    fx = clip_ties(x - x0.to(x.dtype), 0.0, 1.0)
    flat = volume.reshape((d * h * w,) + tuple(volume.shape[3:]))

    def g(zi, yi, xi):
        return flat[(zi * h + yi) * w + xi]

    if volume.dim() == 4:
        fz, fy, fx, inside = fz[..., None], fy[..., None], fx[..., None], inside[..., None]
    if z_first:
        c00 = _lerp(g(z0, y0, x0), g(z1, y0, x0), fz)
        c01 = _lerp(g(z0, y0, x1), g(z1, y0, x1), fz)
        c10 = _lerp(g(z0, y1, x0), g(z1, y1, x0), fz)
        c11 = _lerp(g(z0, y1, x1), g(z1, y1, x1), fz)
        out = _lerp(_lerp(c00, c10, fy), _lerp(c01, c11, fy), fx)
    else:
        c00 = _lerp(g(z0, y0, x0), g(z0, y0, x1), fx)
        c01 = _lerp(g(z0, y1, x0), g(z0, y1, x1), fx)
        c10 = _lerp(g(z1, y0, x0), g(z1, y0, x1), fx)
        c11 = _lerp(g(z1, y1, x0), g(z1, y1, x1), fx)
        out = _lerp(_lerp(c00, c01, fy), _lerp(c10, c11, fy), fz)
    return torch.where(inside, out, torch.as_tensor(outside, dtype=out.dtype, device=out.device))


# ---------------------------------------------------------------------------
# Map algebra
# ---------------------------------------------------------------------------


def identity(shape, device, linspace: bool = False) -> torch.Tensor:
    """(D, H, W, 3) normalized coordinates: i * f32(1 / (n - 1)) with the last
    exactly 1, or (`linspace`) linspace in float64 rounded once."""
    axes = []
    for n in shape:
        if linspace:
            v = np.linspace(0.0, 1.0, int(n), dtype=np.float32)
        else:
            v = np.arange(n, dtype=np.float32) * (np.float32(1.0) / np.float32(max(n - 1, 1)))
            v[-1] = 1.0 if n > 1 else 0.0
        axes.append(torch.as_tensor(v, device=device))
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([zz, yy, xx], dim=-1)


def _scale(shape, device):
    return torch.as_tensor([s - 1.0 for s in shape], dtype=torch.float32, device=device)


def warp(volume, phi):
    """out(x) = volume(phi(x)), zero outside."""
    return gather(volume, phi * _scale(volume.shape, phi.device), 0.0)


def compose(outer, inner):
    """(outer o inner)(x), the inner points clipped to the unit cube."""
    pts = clip_ties(inner, 0.0, 1.0)
    return gather(outer, pts * _scale(outer.shape[:3], pts.device), 0.0)


def resize_field(phi, shape):
    ident = identity(shape, phi.device)
    return gather(phi, ident * _scale(phi.shape[:3], phi.device), 0.0)


def downsample2x(v):
    d, h, w = (s // 2 for s in v.shape)
    return v[: 2 * d, : 2 * h, : 2 * w].reshape(d, 2, h, 2, w, 2).sum(dim=(1, 3, 5)) * 0.125


def pyramid(v, scale: int):
    for _ in range(int.bit_length(int(scale)) - 1):
        v = downsample2x(v)
    return v


def _box_sum(x, win: int):
    lo = (win - 1) // 2
    nd = x.dim()
    for axis in range(nd - 3, nd):
        pad = [0, 0] * (nd - 1 - axis) + [lo, win - 1 - lo]
        x = F.pad(x, pad).unfold(axis, win, 1).sum(-1)
    return x


def lncc(a, b, win: int = 5, eps: float = 1e-5):
    """1 - mean local squared normalized cross-correlation over win^3 boxes
    (SAME zero padding)."""
    cnt = _box_sum(torch.ones_like(a), win)
    s = _box_sum(torch.stack([a, b, a * a, b * b, a * b]), win)
    mu_a, mu_b = s[0] / cnt, s[1] / cnt
    var_a = s[2] / cnt - mu_a * mu_a
    var_b = s[3] / cnt - mu_b * mu_b
    cov = s[4] / cnt - mu_a * mu_b
    return 1.0 - torch.mean((cov * cov) / (var_a * var_b + eps))


def similarity(kind: str, win: int, mse_weight: float):
    def sim(a, b):
        total = 0.0
        if "lncc" in kind:
            total = total + lncc(a, b, win)
        if "mse" in kind:
            total = total + mse_weight * torch.mean((a - b) ** 2)
        return total

    return sim


def gradicon_penalty(phi_ab, phi_ba):
    """|| d/dx (phi_AB o phi_BA) - I ||^2 by forward differences."""
    comp = compose(phi_ab, phi_ba)
    shape = comp.shape[:3]
    eye = torch.eye(3, dtype=comp.dtype, device=comp.device)
    total = 0.0
    for axis in range(3):
        d = torch.diff(comp, dim=axis) * (shape[axis] - 1)
        total = total + torch.mean(torch.sum((d - eye[axis]) ** 2, dim=-1))
    return total


def gradicon_penalty_alternating(phi_ab, phi_ba):
    return 0.5 * (gradicon_penalty(phi_ab.detach(), phi_ba) + gradicon_penalty(phi_ba.detach(), phi_ab))


def diffusion_penalty(phi):
    u = phi - identity(phi.shape[:3], phi.device)
    total = 0.0
    for axis in range(3):
        d = torch.diff(u, dim=axis) * (phi.shape[axis] - 1)
        total = total + torch.mean(torch.sum(d * d, dim=-1))
    return total


# ---------------------------------------------------------------------------
# UNet forward
# ---------------------------------------------------------------------------


def unet_forward(params: Dict[str, Dict[str, torch.Tensor]], enc, dec, x: torch.Tensor,
                 prec: Precision, classwise: bool = False) -> torch.Tensor:
    """x (N, D, H, W, Cin) -> f32 logits (N, D, H, W, n_classes) of a UNet
    with bias and no batch norm: each 3x3x3 conv takes operands rounded to
    the precision, accumulates in f32, adds the bias, applies ReLU and
    rounds its output once; 2x max-pool; the k2s2 upconv and the 1x1x1 head
    are f32 products of the rounded operands, the upconv followed by bias
    and ReLU."""
    r = prec.r

    def conv(h, name):
        k = r(params[name]["kernel"]).permute(4, 3, 0, 1, 2)
        y = F.conv3d(h, k, bias=params[name]["bias"].to(torch.float32), padding=1)
        return r(torch.relu(y))

    def up(h, name):
        w = r(params[name]["kernel"])  # (2, 2, 2, Cin, Cout)
        y = torch.einsum("nidhw,abcio->nodahbwc", h, w)
        n, co, d, _, hh, _, ww, _ = y.shape
        y = y.reshape(n, co, 2 * d, 2 * hh, 2 * ww) + params[name]["bias"].view(1, -1, 1, 1, 1)
        return r(torch.relu(y))

    with prec.products():
        h = r(x.permute(0, 4, 1, 2, 3))
        skips = []
        for li in range(len(enc)):
            h = conv(h, f"enc{li}a")
            h = conv(h, f"enc{li}b")
            if li < len(enc) - 1:
                skips.append(h)
                h = F.max_pool3d(h, 2)
        for li in range(len(dec)):
            u = up(h, f"dec{li}up")
            h = torch.cat([u, skips[len(skips) - 1 - li]], dim=1)
            h = conv(h, f"dec{li}a")
            h = conv(h, f"dec{li}b")
        heads = [f"head{c}" for c in range(2)] if classwise else ["head"]
        outs = []
        for name in heads:
            k = r(params[name]["kernel"])[0, 0, 0]  # (Cin, Cout)
            outs.append(torch.einsum("ncdhw,co->ndhwo", h, k) + params[name]["bias"])
        return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# Optax's Adam and global-norm clip
# ---------------------------------------------------------------------------


def bias_correction(decay: float, count: int) -> float:
    d = np.float32(decay)
    return float(np.float32(1.0) - np.float32(np.float64(d) ** int(count)))


class Adam:
    """mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, p -= lr (mu / bc1) /
    (sqrt(nu / bc2) + eps), with f32 bias corrections; optional global-norm
    clip of the gradients before it (g -> g / norm * clip where norm >= clip)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, b1=0.9, b2=0.999, eps=1e-8, clip=None):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps, self.clip = lr, b1, b2, eps, clip
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Update the parameters in place from `grads`; returns the gradients
        as the moments took them (after the clip)."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        if self.clip is not None:
            norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads))
            keep = norm < self.clip
            grads = [torch.where(keep, g, g / norm * self.clip) for g in grads]
        self.count += 1
        bc1, bc2 = bias_correction(self.b1, self.count), bias_correction(self.b2, self.count)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.add_((m / bc1) / (torch.sqrt(v / bc2) + self.eps), alpha=-self.lr)
        return grads
