"""The port's conv under autograd (`ops.cuda_conv.Conv3dFn`, `conv3d_train`)
on the CPU, where its forward, data gradient and weight gradient take the
plain versions: dx, dW and db against autograd through `conv3d_reference`
(f32 at 1e-5, bf16 at 2e-2: one bf16 rounding of the same f32 sums), the
flipped-kernel identity of the data gradient, and no data gradient when the
input needs none. The kernels under autograd run on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 11)."""

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu_torch.ops import cuda_conv

torch.set_num_threads(2)

# (x shape, Cout): ragged channels with B = 2, Cin = 1, Cin > Cout (the
# data gradient's channels swap), a 24 -> 2 data gradient (GradICON enc0a)
CASES = [((2, 4, 5, 6, 3), 5), ((1, 3, 4, 5, 1), 4), ((2, 3, 4, 4, 7), 2), ((1, 4, 4, 4, 2), 24)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _leaves(shape, cout, dtype, use_bias, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32)).to(dtype)
    k = torch.tensor(rng.normal(0, 0.3, (3, 3, 3, shape[-1], cout)).astype(np.float32)).to(dtype)
    b = torch.tensor(rng.normal(0, 0.5, (cout,)).astype(np.float32)) if use_bias else None
    dy = torch.tensor(rng.normal(0, 1, shape[:-1] + (cout,)).astype(np.float32))
    return x, k, b, dy


def _grads(fn, x, k, b, dy, out_dtype):
    leaves = [t.detach().clone().requires_grad_() for t in (x, k) + ((b,) if b is not None else ())]
    out = fn(leaves[0], leaves[1], leaves[2] if b is not None else None, out_dtype)
    grads = torch.autograd.grad(out, leaves, dy.to(out.dtype))
    return out.detach(), grads


@pytest.mark.parametrize("shape,cout", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_bias,relu", [(True, True), (False, False), (True, False), (False, True)])
def test_conv3d_train_grads_match_plain(shape, cout, dtype, use_bias, relu):
    x, k, b, dy = _leaves(shape, cout, dtype, use_bias)
    out_dtype = dtype

    def train(x_, k_, b_, od):
        return cuda_conv.conv3d_train(x_, k_, b_, relu=relu, out_dtype=od)

    def plain(x_, k_, b_, od):
        return cuda_conv.conv3d_reference(x_, k_, b_, relu=relu, out_dtype=od)

    got_out, got = _grads(train, x, k, b, dy, out_dtype)
    want_out, want = _grads(plain, x, k, b, dy, out_dtype)
    tol = TOL[dtype]
    torch.testing.assert_close(got_out.float(), want_out.float(), atol=tol, rtol=tol)
    assert [g.dtype for g in got] == [g.dtype for g in want]
    for g, w, name in zip(got, want, ("dx", "dW", "db")):
        # the weight gradient sums over every voxel: relative to its scale
        scale = 1.0 if name == "dx" else float(w.float().abs().max())
        torch.testing.assert_close(g.float() / scale, w.float() / scale, atol=tol, rtol=tol, msg=name)


def test_bn_route_f32_out_of_bf16_operands():
    """The BN route: bf16 operands, no ReLU, f32 output; the data gradient
    rounds the f32 output gradient to bf16 once."""
    x, k, b, dy = _leaves((2, 3, 4, 5, 4), 6, torch.bfloat16, True, seed=3)
    got_out, got = _grads(lambda *a: cuda_conv.conv3d_train(*a[:3], relu=False, out_dtype=a[3]),
                          x, k, b, dy, torch.float32)
    want_out, want = _grads(lambda *a: cuda_conv.conv3d_reference(*a[:3], relu=False, out_dtype=a[3]),
                            x, k, b, dy, torch.float32)
    assert got_out.dtype == torch.float32 and got[0].dtype == torch.bfloat16
    torch.testing.assert_close(got_out, want_out)
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float() / scale, w.float() / scale, atol=2e-2, rtol=2e-2)


def test_dgrad_is_the_flipped_swapped_conv():
    """dx = conv3d(dy * mask, kernel flipped in z, y, x with Cin <-> Cout)."""
    x, k, b, dy = _leaves((1, 4, 5, 6, 3), 5, torch.float32, True, seed=1)
    xg = x.clone().requires_grad_()
    out = cuda_conv.conv3d_train(xg, k, b, relu=True)
    (dx,) = torch.autograd.grad(out, xg, dy)
    want = cuda_conv.conv3d_reference((dy * (out.detach() > 0)).contiguous(), cuda_conv.dgrad_kernel(k))
    assert cuda_conv.dgrad_kernel(k).shape == (3, 3, 3, 5, 3)
    torch.testing.assert_close(dx, want, atol=0, rtol=0)
    # the plain weight gradient is the conv's correlation over voxels
    gw = cuda_conv.conv3d_weight_grad_reference(x, dy)
    assert gw.shape == k.shape and gw.dtype == torch.float32


def test_no_dgrad_when_input_needs_none(monkeypatch):
    """An input without requires_grad (a UNet's image) gets no data-gradient
    conv: only the forward calls `conv3d`."""
    x, k, b, dy = _leaves((1, 3, 4, 5, 2), 4, torch.float32, True, seed=2)
    calls = []
    real = cuda_conv.conv3d

    def counting(*args, **kwargs):
        calls.append(args[1].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(cuda_conv, "conv3d", counting)
    kg = k.clone().requires_grad_()
    out = cuda_conv.conv3d_train(x, kg, b, relu=True)
    out.backward(dy)
    assert kg.grad is not None and calls == [k.shape]
    xg = x.clone().requires_grad_()
    cuda_conv.conv3d_train(xg, kg, b, relu=True).backward(dy)
    assert calls == [k.shape, k.shape, cuda_conv.dgrad_kernel(k).shape]
    # CPU tensors launch nothing, so no count moves
    assert real.launches_dgrad == 0
