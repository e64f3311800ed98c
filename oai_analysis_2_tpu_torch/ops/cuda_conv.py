"""3x3x3 SAME convolution: the wrapper of the Hopper kernel `csrc/conv3d.cu`
and its plain PyTorch version.

Replaces the TPU kernel `_kernel`/`conv3d_zstack`
(`oai_analysis_2_tpu/ops/pallas_conv.py:100-243`) and keeps its contract:
NDHWC input, DHWIO weights, optional f32 bias, optional ReLU, bias + ReLU +
ONE output cast applied to the f32 accumulator. The bf16 build has bf16
operands and f32 accumulation; the f32 build has f32 operands and f32
accumulation without TF32. What bounds the kernel on the card and what its
design does about it is written at the top of the CUDA source.

`conv3d` takes the plain version ONLY for tensors on the CPU. A CUDA tensor
launches the kernel or raises; `conv3d.launches` counts the launches and
`conv3d.launches_f32` the f32 build's share of them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

_DTYPES = (torch.bfloat16, torch.float32)


def conv3d_reference(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    relu: bool = False,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version: 27 shifted (voxels, Cin) @ (Cin, Cout) products
    of the zero-padded input, accumulated in f32 (bf16 operands are exact in
    f32), then bias, ReLU and one cast."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    b, d, h, w, _ = x.shape
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1, 1, 1))
    kf = kernel.to(torch.float32)
    acc = None
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                term = xp[:, dz : dz + d, dy : dy + h, dx : dx + w, :] @ kf[dz, dy, dx]
                acc = term if acc is None else acc.add_(term)
    if bias is not None:
        acc = acc + bias.to(torch.float32)
    if relu:
        acc = torch.relu(acc)
    return acc.to(out_dtype)


def _check(x: torch.Tensor, kernel: torch.Tensor, bias, out_dtype) -> None:
    if x.dim() != 5 or kernel.dim() != 5 or tuple(kernel.shape[:3]) != (3, 3, 3):
        raise ValueError(f"conv3d: want x (B,D,H,W,Cin) and kernel (3,3,3,Cin,Cout), got {tuple(x.shape)}, {tuple(kernel.shape)}")
    if kernel.shape[3] != x.shape[4]:
        raise ValueError(f"conv3d: kernel Cin {kernel.shape[3]} != input Cin {x.shape[4]}")
    if x.dtype not in _DTYPES or kernel.dtype != x.dtype:
        raise TypeError(f"conv3d: x and kernel must both be bf16 or both f32, got {x.dtype}, {kernel.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"conv3d: out_dtype must be bf16 or f32, got {out_dtype}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (kernel.shape[4],)):
        raise TypeError("conv3d: bias must be f32 of shape (Cout,)")
    for name, t in (("x", x), ("kernel", kernel), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"conv3d: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"conv3d: {name} must be contiguous")
    if x.numel() >= 2**31 * x.shape[4] or x.shape[4] * 27 >= 2**31:
        raise ValueError("conv3d: shape exceeds the kernel's index range")


def conv3d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    relu: bool = False,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """x (B, D, H, W, Cin), kernel (3, 3, 3, Cin, Cout), bias (Cout,) f32 or
    None -> (B, D, H, W, Cout) in `out_dtype` (default: x's dtype)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return conv3d_reference(x, kernel, bias, relu=relu, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d: unsupported device {x.device}")
    _check(x, kernel, bias, out_dtype)
    from oai_analysis_2_tpu_torch.ops.cuda_build import load_library

    lib = load_library("conv3d")
    fn = lib.conv3d_bf16 if x.dtype == torch.bfloat16 else lib.conv3d_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, d, h, w, cin = x.shape
    cout = kernel.shape[4]
    out = torch.empty((b, d, h, w, cout), dtype=out_dtype, device=x.device)
    ptrs = [x.data_ptr(), kernel.data_ptr(), out.data_ptr()]
    if bias is not None:
        ptrs.append(bias.data_ptr())
    vec_ok = int(all(p % 16 == 0 for p in ptrs))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, d, h, w, cin, cout, int(relu), int(out_dtype == torch.bfloat16), vec_ok, stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3d kernel launch failed with CUDA error {err}")
    conv3d.launches += 1
    if x.dtype == torch.float32:
        conv3d.launches_f32 += 1
    return out


conv3d.launches = 0
conv3d.launches_f32 = 0
