"""3x3x3 SAME convolution: the wrapper of the Hopper kernels
`csrc/conv3d_sm90.cu`, `csrc/conv3d_sm90n.cu`, `csrc/conv3d_cin1.cu`,
`csrc/conv3d_f32.cu` and `csrc/conv3d.cu`, and their plain PyTorch version.

Replaces the TPU kernel `_kernel`/`conv3d_zstack`
(`oai_analysis_2_tpu/ops/pallas_conv.py:100-243`) and keeps its contract:
NDHWC input, DHWIO weights, optional f32 bias, optional ReLU, bias + ReLU +
ONE output cast applied to the f32 accumulator. The bf16 build has bf16
operands and f32 accumulation; the f32 build has f32 operands and f32
accumulation without TF32. What bounds the kernel on the card and what its
design does about it is written at the top of each CUDA source.

Routes (`conv3d_route`, by channel counts and type alone):
  * "sm90": bf16 with Cin % 16 == 0 and Cout % 64 == 0, the TMA + wgmma
    kernel of `csrc/conv3d_sm90.cu` (every segment-UNet conv but the first).
    It takes the weights as (27, Cout, Cin), re-laid out here per call;
  * "cin1": bf16 with Cin == 1, Cout % 8 == 0 and Cout <= 64 (every UNet's
    enc0a), the mma.sync kernel of `csrc/conv3d_cin1.cu` (the input box
    landed by TMA, products from ldmatrix, the output staged in shared
    memory and stored by TMA). It takes the weights as (32, Cout), re-laid
    out here per call;
  * "sm90n": any other bf16 shape with Cin % 8 == 0 (the GradICON stage
    convs, forward and data gradient; the UNet's enc0b data gradient), the
    TMA + wgmma kernel of `csrc/conv3d_sm90n.cu` at narrow and ragged
    widths: wgmma N = Cout rounded up to 8 (wider Cout in equal n-tiles),
    channel chunks whose ragged end TMA zero-fills, the tile chosen by
    `sm90n_tile`. It takes the weights as sm90 does;
  * "wmma": bf16 with Cin % 8 != 0 (the GradICON enc0a forward, Cin 2),
    the wmma build of `csrc/conv3d.cu`;
  * "f32": f32 operands (the GradICON stages), the CUDA-core kernel of
    `csrc/conv3d_f32.cu` (cp.async ring, 8 x 8 register tiles, the tile
    chosen by `f32_tile`).

`conv3d` takes the plain version ONLY for tensors on the CPU. A CUDA tensor
launches its route's kernel or raises: no route falls back to another.
`conv3d.launches` counts every launch, `conv3d.launches_<route>` each
route's share. `launch` is the uncounted launcher under `conv3d`, open
to measurements that time a route at another's shape (the wmma build at
enc0a's or at an sm90n shape), the sm90 or sm90n kernel's loads alone, the
cin1 kernel's stores alone or
its general load and store paths, or the f32 build that the "f32" route replaced (route "f32_was", the CUDA-core
build of `csrc/conv3d.cu`).

Training (`conv3d_train`, `Conv3dFn`): the forward is `conv3d` itself (the
same route, kernel and epilogue); the data gradient is `conv3d` again, of
the ReLU-masked output gradient with the kernel flipped in z, y and x and
Cin <-> Cout swapped, so it takes whatever route the swapped channels pick
and is counted apart as well (`conv3d.launches_dgrad` and
`conv3d.launches_dgrad_<route>`). The weight gradient, which the JAX
package leaves to XLA, is a library call on the card
(`torch.nn.grad.conv3d_weight`, cuDNN, TF32 off for f32 operands) and 27
shifted products on the CPU (`conv3d_weight_grad_reference`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

_DTYPES = (torch.bfloat16, torch.float32)
ROUTES = ("sm90", "sm90n", "cin1", "wmma", "f32")
# what `launch` takes: the routes, and the f32 build that the "f32" route
# replaced (the CUDA-core kernel of csrc/conv3d.cu), which `conv3d` never takes
BUILDS = ROUTES + ("f32_was",)
_F32_TILE_OUTPUTS = 12288  # BM * BN of csrc/conv3d_f32.cu: 192 threads of 8 x 8
_SMS = 132  # streaming multiprocessors of an H100 SXM
# the sm90n kernel's wgmma widths and, for each, its m64 tiles a consumer
# warpgroup: the accumulator takes MW * N / 2 registers a thread, and a
# block of 288 threads may hold 168 registers a thread (above 96 for the
# accumulator, ptxas spills)
SM90N_BN = (8, 24, 32, 48, 64, 96, 144, 192)
_SM90N_MW = {8: (1, 2, 3), 24: (1, 2, 3), 32: (1, 2, 3), 48: (1, 2, 3), 64: (1, 2, 3), 96: (1, 2), 144: (1,),
             192: (1,)}


def conv3d_route(cin: int, cout: int, dtype: torch.dtype) -> str:
    """The kernel that `conv3d` launches for `cin` -> `cout` channels and
    operand type `dtype`; every spatial shape takes the same route."""
    if dtype == torch.float32:
        return "f32"
    if cin % 16 == 0 and cout % 64 == 0:
        return "sm90"
    if cin == 1 and cout % 8 == 0 and cout <= 64:
        return "cin1"
    if cin % 8 == 0:
        return "sm90n"
    return "wmma"


def sm90n_stages(bkc: int, bn: int, mw: int) -> int:
    """Ring stages of the sm90n kernel's block (`Cfg::STAGES` of
    `csrc/conv3d_sm90n.cu`): the (BX + 2) x 8 activation box and the 3 x BN
    weight box of one chunk, each padded to 1 KB, as many as fit in 225 KB
    less 2 KB, at most 8."""
    def pad(v):
        return -(-v // 1024) * 1024

    stage = pad((16 * mw + 2) * 8 * 2 * bkc) + pad(3 * bn * 2 * bkc)
    return min(8, (225 * 1024 - 2048) // stage)


def sm90n_tile(cin: int, cout: int, shape) -> tuple:
    """(BKC input channels a chunk, BN output channels an n-tile, n-tiles,
    MW m64 tiles a consumer) of the sm90n kernel for `cin` -> `cout` over an
    output of `shape` (B, D, H, W). BN: the narrowest wgmma width that
    holds an equal share of Cout in ceil(Cout / 192) tiles. BKC: the widest
    of 64, 32 and 16 channels whose chunks, zero-filled past Cin, pad K by
    at most 15 % over 16-channel chunks (on an H100 the load pipeline, which
    bounds this kernel, moves wide rows faster than it loses to the
    padding: Cin 24 and 144 take 32, 288 takes 64, 48 takes 16), halved
    while fewer than three stages fit. MW: of BN's choices the one that
    takes the fewest waves of one block per SM, each weighted by the
    block's work (MW + 1/2), the larger on a tie."""
    b, d, h, w = shape
    n_tiles = -(-cout // 192)
    share = -(-cout // n_tiles)
    bn = min(v for v in SM90N_BN if v >= share)
    best = None
    for mw in _SM90N_MW[bn]:
        bkc = max(v for v in (64, 32, 16) if -(-cin // v) * v <= 1.15 * -(-cin // 16) * 16)
        while sm90n_stages(bkc, bn, mw) < 3:
            bkc //= 2
        blocks = n_tiles * -(-w // (16 * mw)) * -(-h // 8) * d * b
        cost = (-(-blocks // _SMS) * (mw + 0.5), -mw)
        if best is None or cost < best[0]:
            best = (cost, (bkc, bn, n_tiles, mw))
    return best[1]


def f32_tile(cout: int, voxels: int) -> tuple:
    """(BM voxels, BN channels, KS K groups) of the f32 kernel's block for
    `cout` output channels over `voxels` output voxels: of BN = 96, 48, 24
    the one that pads Cout least (the wider on a tie) and BM = 12288 / BN;
    where that gives fewer than two blocks per SM of an H100, BM is halved,
    and K is split inside the block in 2 groups, or 4 (2 at BN = 24) where
    the blocks do not reach one per SM."""
    bn = min((96, 48, 24), key=lambda n: (-(-cout // n) * n, -n))
    bm = _F32_TILE_OUTPUTS // bn

    def blocks(rows):
        return -(-voxels // rows) * -(-cout // bn)

    if blocks(bm) >= 2 * _SMS:
        return bm, bn, 1
    bm //= 2
    if blocks(bm) >= 2 * _SMS:
        return bm, bn, 1
    return bm, bn, 2 if blocks(bm) >= _SMS or bn == 24 else 4


def sm90_weights(kernel: torch.Tensor) -> torch.Tensor:
    """DHWIO (3, 3, 3, Cin, Cout) -> (27, Cout, Cin): tap-major, then the
    K-major rows that the sm90 kernel's wgmma reads as its B operand."""
    cin, cout = kernel.shape[3], kernel.shape[4]
    return kernel.reshape(27, cin, cout).transpose(1, 2).contiguous()


def cin1_weights(kernel: torch.Tensor) -> torch.Tensor:
    """DHWIO (3, 3, 3, 1, Cout) -> (32, Cout): the 27 taps in DHWIO order
    (tap = (kz * 3 + ky) * 3 + kx), then 5 zero rows, the K = 32 of the cin1
    kernel's two m16n8k16 steps."""
    cout = kernel.shape[4]
    return F.pad(kernel.reshape(27, cout), (0, 0, 0, 5)).contiguous()


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
    route = conv3d_route(x.shape[-1], kernel.shape[-1], x.dtype)
    out = launch(x, kernel, bias, route=route, relu=relu, out_dtype=out_dtype)
    conv3d.launches += 1
    setattr(conv3d, f"launches_{route}", getattr(conv3d, f"launches_{route}") + 1)
    return out


def launch(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    route: str,
    relu: bool = False,
    out_dtype: Optional[torch.dtype] = None,
    loads_only: bool = False,
    compute_only: bool = False,
    stores_only: bool = False,
    general: bool = False,
) -> torch.Tensor:
    """Launch `route`'s kernel on CUDA tensors, uncounted: `conv3d` calls it
    with the route of the shape and counts the launch. Called directly, it
    times one build at a shape another route owns, the f32 build that the
    "f32" route replaced (route="f32_was"), or (`loads_only`, sm90 and
    sm90n) the kernel's load pipeline alone, whose output is left
    unwritten, or
    (`compute_only`, f32) the f32 kernel's multiplies alone, without its
    copies, whose output is garbage, or (`stores_only`, cin1) the cin1
    kernel's stores alone, without its loads and products, whose output is
    relu?(bias), not the conv, or (`general`, cin1) the cin1 kernel with
    its cp.async landing and `cp.async.bulk` row stores at any shape, in
    place of the TMA landing and TMA store that enc0a's shape takes."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if route not in BUILDS or route.startswith("f32") != (x.dtype == torch.float32):
        raise ValueError(f"conv3d: route {route!r} does not take {x.dtype} operands")
    if loads_only and route not in ("sm90", "sm90n"):
        raise ValueError("conv3d: only the sm90 and sm90n routes have a loads-only build")
    if compute_only and route != "f32":
        raise ValueError("conv3d: only the f32 route has a compute-only build")
    if stores_only and route != "cin1":
        raise ValueError("conv3d: only the cin1 route has a stores-only build")
    if general and route != "cin1":
        raise ValueError("conv3d: only the cin1 route has a general build")
    if route == "sm90n" and x.shape[-1] % 8:
        raise ValueError(f"conv3d: the sm90n route needs Cin % 8 == 0, got {x.shape[-1]}")
    if x.device.type != "cuda":
        raise ValueError(f"conv3d: unsupported device {x.device}")
    _check(x, kernel, bias, out_dtype)
    from oai_analysis_2_tpu_torch.ops.cuda_build import load_library

    b, d, h, w, cin = x.shape
    cout = kernel.shape[4]
    out = torch.empty((b, d, h, w, cout), dtype=out_dtype, device=x.device)
    bias_ptr = None if bias is None else bias.data_ptr()
    if route in ("sm90", "sm90n"):
        if route == "sm90" and (cin % 16 or cout % 64):
            raise ValueError(f"conv3d: the sm90 route needs Cin % 16 == 0 and Cout % 64 == 0, got {cin}, {cout}")
        # TMA needs a 16-byte-aligned base; wt and out are fresh allocations
        if x.data_ptr() % 16:
            raise ValueError(f"conv3d: the {route} route needs 16-byte-aligned x (check its storage offset)")
        wt = sm90_weights(kernel)
        fn = getattr(load_library(f"conv3d_{route}"), f"conv3d_{route}")
        tile = list(sm90n_tile(cin, cout, (b, d, h, w))) if route == "sm90n" else []
        args = [x.data_ptr(), wt.data_ptr(), bias_ptr, out.data_ptr(), b, d, h, w, cin, cout,
                int(relu), int(out_dtype == torch.bfloat16), *tile, int(loads_only)]
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (len(args) - 4) + [ctypes.c_void_p]
    elif route == "cin1":
        if cin != 1 or cout % 8 or cout > 64:
            raise ValueError(f"conv3d: the cin1 route needs Cin == 1, Cout % 8 == 0 and Cout <= 64, got {cin}, {cout}")
        # the 16-byte copies need a 16-byte-aligned x and out; out is a fresh allocation
        if x.data_ptr() % 16:
            raise ValueError("conv3d: the cin1 route needs 16-byte-aligned x (check its storage offset)")
        wt = cin1_weights(kernel)
        fn = load_library("conv3d_cin1").conv3d_cin1
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        args = [x.data_ptr(), wt.data_ptr(), bias_ptr, out.data_ptr(), b, d, h, w, cout,
                int(relu), int(out_dtype == torch.bfloat16), int(stores_only), int(general)]
    else:
        ptrs = [x.data_ptr(), kernel.data_ptr(), out.data_ptr()] + ([] if bias is None else [bias_ptr])
        vec_ok = int(all(p % 16 == 0 for p in ptrs))
        args = [x.data_ptr(), kernel.data_ptr(), bias_ptr, out.data_ptr(), b, d, h, w, cin, cout,
                int(relu), int(out_dtype == torch.bfloat16)]
        if route == "f32":
            fn = load_library("conv3d_f32").conv3d_f32
            args += [*f32_tile(cout, b * d * h * w), vec_ok, int(compute_only)]
        else:
            lib = load_library("conv3d")
            fn = lib.conv3d_bf16 if route == "wmma" else lib.conv3d_f32
            args.append(vec_ok)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (len(args) - 4) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d: {route} kernel launch failed with {_error_text(err)}")
    return out


def dgrad_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """DHWIO (3, 3, 3, Cin, Cout) -> (3, 3, 3, Cout, Cin): the kernel whose
    SAME conv of an output gradient is the input gradient (flipped in z, y
    and x, input and output channels swapped)."""
    return kernel.flip(0, 1, 2).transpose(3, 4).contiguous()


def conv3d_weight_grad_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain weight gradient of the SAME 3x3x3 conv: x (B, D, H, W, Cin) and
    the output gradient g (B, D, H, W, Cout) -> (3, 3, 3, Cin, Cout) f32,
    27 shifted (Cin, voxels) @ (voxels, Cout) products of the zero-padded
    input in f32."""
    b, d, h, w, cin = x.shape
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1, 1, 1))
    gf = g.to(torch.float32).reshape(-1, g.shape[-1])
    taps = [xp[:, dz : dz + d, dy : dy + h, dx : dx + w, :].reshape(-1, cin).t() @ gf
            for dz in range(3) for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, 3, cin, g.shape[-1])


def conv3d_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient in x's dtype: the plain version for CPU tensors,
    on the card one cuDNN weight-gradient call on the channels-last views
    (TF32 off for f32 operands, so the f32 route's gradient stays f32)."""
    if x.device.type == "cpu":
        return conv3d_weight_grad_reference(x, g).to(x.dtype)
    cin, cout = x.shape[-1], g.shape[-1]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        gw = torch.nn.grad.conv3d_weight(x.permute(0, 4, 1, 2, 3), (cout, cin, 3, 3, 3),
                                         g.to(x.dtype).permute(0, 4, 1, 2, 3), padding=1)
    return gw.permute(2, 3, 4, 1, 0).contiguous()


class Conv3dFn(torch.autograd.Function):
    """`conv3d` under autograd. Forward: `conv3d` (saves x, the kernel and
    the output; under the fused ReLU the gradient mask is `out > 0`).
    Backward: the input gradient through `conv3d` with `dgrad_kernel`
    (skipped when x needs no gradient, as for a UNet's input image), the
    weight gradient through `conv3d_weight_grad`, the bias gradient the
    masked output gradient summed over voxels in f32."""

    @staticmethod
    def forward(ctx, x, kernel, bias, relu, out_dtype):
        out = conv3d(x, kernel, bias, relu=relu, out_dtype=out_dtype)
        ctx.relu = relu
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, kernel, out if relu else None)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, kernel, out = ctx.saved_tensors
        g = dy * (out > 0) if ctx.relu else dy
        g = g.contiguous()
        dx = dk = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3d(g.to(x.dtype), dgrad_kernel(kernel), None, relu=False, out_dtype=x.dtype)
            if x.device.type == "cuda":
                route = conv3d_route(kernel.shape[4], kernel.shape[3], x.dtype)
                conv3d.launches_dgrad += 1
                setattr(conv3d, f"launches_dgrad_{route}", getattr(conv3d, f"launches_dgrad_{route}") + 1)
        if ctx.needs_input_grad[1]:
            dk = conv3d_weight_grad(x, g)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.to(torch.float32).sum(dim=(0, 1, 2, 3))
        return dx, dk, db, None, None


def conv3d_train(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    relu: bool = False,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """`conv3d` with gradients for x, the kernel and the bias (`Conv3dFn`)."""
    return Conv3dFn.apply(x, kernel, bias, relu, x.dtype if out_dtype is None else out_dtype)


def _error_text(err: int) -> str:
    if err == -1:
        return "no cuTensorMapEncodeTiled in libcuda"
    if err == -2:
        return "a tile the kernel was not built for"
    if err <= -1000:
        return f"cuTensorMapEncodeTiled error {-err - 1000}"
    return f"CUDA error {err}"


def reset_launches() -> None:
    """Zero the total, every route's launch count and the data-gradient
    counts (a data gradient counts in the total and its route's count too)."""
    conv3d.launches = 0
    conv3d.launches_dgrad = 0
    for route in ROUTES:
        setattr(conv3d, f"launches_{route}", 0)
        setattr(conv3d, f"launches_dgrad_{route}", 0)


reset_launches()
