"""The PyTorch port's 3x3x3 conv and UNet against the JAX package.

Inputs come from a numpy seed and go through both packages on the CPU: the
port's plain conv (what its kernel wrapper runs for CPU tensors) against
`models/unet3d.conv3d` (f32) and against the Pallas `conv3d_zstack` in
interpret mode (bf16), and the port's `UNet3D` with carried weights against
`UNet3D.apply`. The kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oai_analysis_2_tpu.models import unet3d as J
from oai_analysis_2_tpu.ops.pallas_conv import conv3d_zstack
from oai_analysis_2_tpu_torch.models import unet3d as T
from oai_analysis_2_tpu_torch.models.gradicon import _stage_spec
from oai_analysis_2_tpu_torch.ops import cuda_conv
from oai_analysis_2_tpu_torch.utils.checkpoint import carry_params

torch.set_num_threads(2)

# (x shape, Cout): ragged channels, Cin = 1 as in enc0a, a batch of 2
CASES = [((1, 6, 8, 10, 5), 7), ((2, 4, 6, 8, 16), 8), ((1, 5, 7, 6, 1), 3)]


def _inputs(shape, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    k = rng.normal(0, 0.2, (3, 3, 3, shape[-1], cout)).astype(np.float32)
    b = rng.normal(0, 0.5, (cout,)).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("shape,cout", CASES)
@pytest.mark.parametrize("use_bias", [False, True])
def test_plain_conv_f32_matches_jax(shape, cout, use_bias):
    x, k, b = _inputs(shape, cout)
    p = {"kernel": jnp.asarray(k)}
    if use_bias:
        p["bias"] = jnp.asarray(b)
    want = np.asarray(J.conv3d(jnp.asarray(x), p))
    got = cuda_conv.conv3d(torch.tensor(x), torch.tensor(k), torch.tensor(b) if use_bias else None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


# and enc0a's contract: Cin = 1 -> Cout = 32 in bf16 (the cin1 route)
@pytest.mark.parametrize("shape,cout", CASES[:2] + [((1, 4, 6, 8, 1), 32)])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_conv_bf16_matches_pallas_interpret(shape, cout, relu):
    """bf16 operands, f32 accumulation, bias + ReLU + one cast: the Pallas
    kernel's contract, run in interpret mode."""
    x, k, b = _inputs(shape, cout, seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = conv3d_zstack(xb, jnp.asarray(k), jnp.asarray(b), relu=relu, out_dtype=jnp.float32,
                         tz=shape[1] // 2, ty=shape[2] // 2, interpret=True)
    xt = torch.tensor(x).to(torch.bfloat16)
    kt = torch.tensor(k).to(torch.bfloat16)
    got = cuda_conv.conv3d(xt, kt, torch.tensor(b), relu=relu, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=3e-2, rtol=3e-2)
    # and the bf16 output cast is the single rounding of that f32 result
    got_bf16 = cuda_conv.conv3d(xt, kt, torch.tensor(b), relu=relu)
    assert got_bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_bf16.float().numpy(), got.to(torch.bfloat16).float().numpy())


def _carried_unets(spec_name, seed=0):
    """The same random weights in the JAX param tree and on the port's module."""
    rng = np.random.default_rng(seed)
    jspec = J.NETWORK_SPECS[spec_name].replace(bias=True)
    shapes = T.param_shapes(T.NETWORK_SPECS[spec_name].replace(bias=True))
    params = {
        name: {leaf: (rng.normal(0, 0.3, s) / np.sqrt(np.prod(s[:-1]))).astype(np.float32)
               for leaf, s in leaves.items()}
        for name, leaves in shapes.items()
    }
    return jspec, params


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_unet_matches_jax(dtype, atol):
    jspec, params = _carried_unets("UNet_light4")
    x = np.random.default_rng(3).normal(0, 1, (1, 8, 16, 12, 1)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(J.UNet3D(jspec, compute_dtype=jdt).apply(params, jnp.asarray(x)))
    net = T.UNet3D(T.NETWORK_SPECS["UNet_light4"].replace(bias=True), compute_dtype=tdt, device="cpu")
    carry_params(net, params)
    got = net(torch.tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=atol)


@pytest.mark.parametrize("spec_name", ["UNet", "UNetClassWise", "UNet_light2"])
def test_threshold_params_match_jax(spec_name):
    jmodel = J.UNet3D(J.NETWORK_SPECS[spec_name].replace(bias=True))
    want = J.make_threshold_params(jmodel, gain=24.0, threshold=0.5)
    got = T.make_threshold_params(T.NETWORK_SPECS[spec_name].replace(bias=True), gain=24.0, threshold=0.5)
    assert set(got) == set(want)
    for name, leaves in want.items():
        assert set(got[name]) == set(leaves)
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(got[name][leaf], np.asarray(v))


def test_carry_params_rejects_mismatched_tree():
    net = T.UNet3D(T.NETWORK_SPECS["UNet_light4"].replace(bias=True), device="cpu")
    _, params = _carried_unets("UNet_light4")
    del params["head"]["bias"]
    with pytest.raises(KeyError):
        carry_params(net, params)


def test_maxpool_floor_semantics():
    x = np.random.default_rng(4).normal(0, 1, (1, 5, 7, 6, 3)).astype(np.float32)
    want = np.asarray(J.maxpool2x(jnp.asarray(x)))
    np.testing.assert_array_equal(T.maxpool2x(torch.tensor(x)).numpy(), want)


def test_conv_wrapper_refuses_other_devices():
    x = torch.zeros((1, 3, 3, 3, 2), device="meta")
    with pytest.raises(ValueError):
        cuda_conv.conv3d(x, torch.zeros((3, 3, 3, 2, 4), device="meta"))


def _conv_shapes(spec):
    """(name, DHWIO kernel shape) of every 3x3x3 conv of a UNet spec."""
    return [(name, leaves["kernel"]) for name, leaves in T.param_shapes(spec).items()
            if leaves["kernel"][:3] == (3, 3, 3)]


SEGMENT_CONVS = _conv_shapes(T.NETWORK_SPECS["UNet"].replace(bias=True))
GRADICON_CONVS = _conv_shapes(_stage_spec(24))


@pytest.mark.parametrize("name,kshape", SEGMENT_CONVS, ids=[n for n, _ in SEGMENT_CONVS])
def test_segment_unet_conv_route(name, kshape):
    """bf16 with Cin % 16 == 0 and Cout % 64 == 0 takes the TMA + wgmma
    kernel: every production-UNet conv but enc0a (Cin = 1), which takes the
    cin1 kernel."""
    cin, cout = kshape[3], kshape[4]
    want = "cin1" if name == "enc0a" else "sm90"
    assert cuda_conv.conv3d_route(cin, cout, torch.bfloat16) == want


@pytest.mark.parametrize("name,kshape", GRADICON_CONVS, ids=[n for n, _ in GRADICON_CONVS])
def test_gradicon_conv_route(name, kshape):
    """The GradICON stages run in f32, whatever their widths (96 -> 192
    would meet the sm90 shape rule in bf16)."""
    cin, cout = kshape[3], kshape[4]
    assert cuda_conv.conv3d_route(cin, cout, torch.float32) == "f32"


@pytest.mark.parametrize("cin,cout,want", [(1, 32, "cin1"), (8, 64, "sm90n"), (16, 48, "sm90n"), (24, 64, "sm90n"),
                                           (16, 64, "sm90"), (96, 192, "sm90"), (1, 8, "cin1"), (1, 16, "cin1"),
                                           (1, 64, "cin1"), (1, 24, "cin1"), (1, 12, "wmma"), (1, 72, "wmma"),
                                           (2, 32, "cinsmall"), (2, 24, "cinsmall"), (2, 64, "cinsmall"),
                                           (2, 72, "wmma"), (2, 12, "wmma"), (3, 40, "cinsmall"), (3, 48, "wmma"),
                                           (4, 32, "cinsmall"), (4, 40, "wmma"), (5, 8, "wmma")])
def test_conv_route_shape_rule(cin, cout, want):
    assert cuda_conv.conv3d_route(cin, cout, torch.bfloat16) == want


@pytest.mark.parametrize("name,kshape", GRADICON_CONVS, ids=[n for n, _ in GRADICON_CONVS])
def test_gradicon_bf16_conv_routes(name, kshape):
    """The bf16 GradICON trainer's routes, forward and data gradient (the
    channels swapped): enc0a's forward (Cin 2) takes the cinsmall kernel,
    enc2b's forward (96 -> 192) the sm90 kernel, every other conv both ways
    the sm90n kernel; none takes the wmma build."""
    cin, cout = kshape[3], kshape[4]
    forward = {"enc0a": "cinsmall", "enc2b": "sm90"}.get(name, "sm90n")
    assert cuda_conv.conv3d_route(cin, cout, torch.bfloat16) == forward
    assert cuda_conv.conv3d_route(cout, cin, torch.bfloat16) == "sm90n"


@pytest.mark.parametrize("cin,cout,shape,want", [
    (144, 48, (1, 48, 96, 96), (32, 48, 1, 3)),
    (48, 144, (1, 48, 96, 96), (16, 144, 1, 1)),
    (96, 288, (1, 24, 48, 48), (32, 144, 2, 1)),
    (288, 96, (1, 24, 48, 48), (64, 96, 1, 1)),
    (24, 2, (1, 48, 96, 96), (32, 8, 1, 3)),
    (64, 32, (2, 32, 128, 128), (64, 32, 1, 2)),
    (8, 1000, (1, 4, 4, 4), (16, 192, 6, 1)),
])
def test_sm90n_tile(cin, cout, shape, want):
    """BN: the narrowest wgmma width holding an equal share of Cout in
    ceil(Cout / 192) tiles; BKC the widest chunk that pads K by at most 15 %;
    MW by the waves; at least three ring stages in 225 KB."""
    tile = cuda_conv.sm90n_tile(cin, cout, shape)
    assert tile == want
    bkc, bn, n_tiles, mw = tile
    assert bn in cuda_conv.SM90N_BN and n_tiles * bn >= cout and cuda_conv.sm90n_stages(bkc, bn, mw) >= 3


@pytest.mark.parametrize("dtype,route,loads_only", [
    (torch.bfloat16, "f32", False), (torch.float32, "sm90", False), (torch.float32, "wmma", False),
    (torch.bfloat16, "cudnn", False), (torch.bfloat16, "wmma", True), (torch.float32, "sm90n", False),
    (torch.bfloat16, "cin1", True),
])
def test_launch_rejects_a_route_that_cannot_take_the_call(dtype, route, loads_only):
    x, k, _ = _inputs((1, 3, 4, 5, 16), 64)
    with pytest.raises(ValueError, match="route|loads-only"):
        cuda_conv.launch(torch.tensor(x).to(dtype), torch.tensor(k).to(dtype), route=route, loads_only=loads_only)


@pytest.mark.parametrize("route", ["sm90", "sm90n"])
def test_launch_has_no_plain_version(route):
    """`launch` is the kernels' launcher: a CPU tensor raises instead of
    taking `conv3d_reference`."""
    x, k, _ = _inputs((1, 3, 4, 5, 16), 64)
    with pytest.raises(ValueError, match="device"):
        cuda_conv.launch(torch.tensor(x).to(torch.bfloat16), torch.tensor(k).to(torch.bfloat16), route=route)


@pytest.mark.parametrize("cin", [2, 12, 20])
def test_sm90n_launcher_refuses_ragged_cin(cin):
    """Cin % 8 != 0 gives activation rows that TMA cannot address: the
    sm90n launcher refuses it before anything else (such shapes take the
    cinsmall kernel at Cin 2-4, the wmma build otherwise)."""
    x, k, _ = _inputs((1, 3, 4, 5, cin), 24)
    with pytest.raises(ValueError, match="Cin % 8"):
        cuda_conv.launch(torch.tensor(x).to(torch.bfloat16), torch.tensor(k).to(torch.bfloat16), route="sm90n")
    assert cuda_conv.conv3d_route(cin, 24, torch.bfloat16) == ("cinsmall" if cin <= 4 else "wmma")


@pytest.mark.parametrize("shape,cout", [((1, 4, 6, 8, 24), 48), ((1, 4, 6, 8, 48), 24)])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_conv_at_sm90n_shapes_matches_pallas_interpret(shape, cout, relu):
    """Two GradICON channel pairs of the sm90n route (enc0b's 24 -> 48 and
    its data gradient's 48 -> 24) in bf16: the port's plain conv against
    the Pallas kernel in interpret mode, within 2e-2 (the same f32 sums in
    another order)."""
    x, k, b = _inputs(shape, cout, seed=2)
    k = k / np.sqrt(27 * shape[-1] / 9)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kb = jnp.asarray(k).astype(jnp.bfloat16)
    want = conv3d_zstack(xb, kb, jnp.asarray(b), relu=relu, out_dtype=jnp.float32,
                         tz=shape[1] // 2, ty=shape[2] // 2, interpret=True)
    got = cuda_conv.conv3d(torch.tensor(x).to(torch.bfloat16), torch.tensor(k).to(torch.bfloat16), torch.tensor(b),
                           relu=relu, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("cout", [24, 8])
def test_plain_conv_at_cinsmall_shapes_matches_pallas_interpret(cout, relu):
    """The GradICON enc0a's channels (2 -> 24, the cinsmall route) and the
    narrowest Cout it takes, in bf16: the port's plain conv against the
    Pallas kernel in interpret mode, within 2e-2 (the same f32 sums in
    another order)."""
    shape = (1, 4, 6, 16, 2)
    x, k, b = _inputs(shape, cout, seed=4)
    k = k / np.sqrt(27 * shape[-1] / 9)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kb = jnp.asarray(k).astype(jnp.bfloat16)
    want = conv3d_zstack(xb, kb, jnp.asarray(b), relu=relu, out_dtype=jnp.float32,
                         tz=shape[1] // 2, ty=shape[2] // 2, interpret=True)
    assert cuda_conv.conv3d_route(shape[-1], cout, torch.bfloat16) == "cinsmall"
    got = cuda_conv.conv3d(torch.tensor(x).to(torch.bfloat16), torch.tensor(k).to(torch.bfloat16), torch.tensor(b),
                           relu=relu, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("cin,cout", [(2, 24), (3, 16), (4, 32)])
def test_cinsmall_weight_layout(cin, cout):
    """(KP, Cout): row tap * Cin + channel, tap = (kz * 3 + ky) * 3 + kx in
    DHWIO order, zero rows up to KP = 16 ceil(27 Cin / 16), against a
    layout written out element by element in numpy."""
    k = np.random.default_rng(cin).normal(size=(3, 3, 3, cin, cout)).astype(np.float32)
    kp = {2: 64, 3: 96, 4: 112}[cin]
    want = np.zeros((kp, cout), np.float32)
    for kz in range(3):
        for ky in range(3):
            for kx in range(3):
                for c in range(cin):
                    want[((kz * 3 + ky) * 3 + kx) * cin + c] = k[kz, ky, kx, c]
    wt = cuda_conv.cinsmall_weights(torch.tensor(k).to(torch.bfloat16))
    assert tuple(wt.shape) == (kp, cout) and wt.is_contiguous() and wt.dtype == torch.bfloat16
    np.testing.assert_array_equal(wt.float().numpy(), torch.tensor(want).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("cin,cout,dtype,match", [
    (2, 24, torch.float32, "route"), (1, 24, torch.bfloat16, "cinsmall"), (8, 24, torch.bfloat16, "cinsmall"),
    (16, 64, torch.bfloat16, "cinsmall"), (5, 24, torch.bfloat16, "cinsmall"), (2, 12, torch.bfloat16, "cinsmall"),
    (2, 72, torch.bfloat16, "cinsmall"), (4, 40, torch.bfloat16, "cinsmall"),
])
def test_cinsmall_launcher_refuses_other_calls(cin, cout, dtype, match):
    """f32 operands, Cin 1 (the cin1 route's), Cin % 8 == 0 (sm90n's or
    sm90's), Cin 5, a Cout that is no multiple of 8 and B fragments past
    the register budget: the launcher raises before it looks at the
    device."""
    x, k, _ = _inputs((1, 3, 4, 16, cin), cout)
    with pytest.raises(ValueError, match=match):
        cuda_conv.launch(torch.tensor(x).to(dtype), torch.tensor(k).to(dtype), route="cinsmall")


def test_cinsmall_launch_has_no_plain_version():
    """`launch` is the kernels' launcher: a CPU tensor at a shape the
    cinsmall kernel takes raises instead of taking `conv3d_reference`."""
    x, k, _ = _inputs((1, 3, 4, 16, 2), 24)
    with pytest.raises(ValueError, match="device"):
        cuda_conv.launch(torch.tensor(x).to(torch.bfloat16), torch.tensor(k).to(torch.bfloat16), route="cinsmall")


def test_sm90_weight_layout():
    """(27, Cout, Cin) with tap = (kz * 3 + ky) * 3 + kx, the DHWIO order."""
    k = torch.arange(3 * 3 * 3 * 5 * 4, dtype=torch.float32).reshape(3, 3, 3, 5, 4)
    wt = cuda_conv.sm90_weights(k)
    assert tuple(wt.shape) == (27, 4, 5) and wt.is_contiguous()
    for kz, ky, kx, ci, co in [(0, 0, 0, 0, 0), (2, 1, 0, 4, 3), (1, 2, 2, 3, 1), (2, 2, 2, 4, 3)]:
        assert wt[(kz * 3 + ky) * 3 + kx, co, ci] == k[kz, ky, kx, ci, co]


def test_cin1_weight_layout():
    """(32, Cout): tap (kz * 3 + ky) * 3 + kx in DHWIO order, rows 27-31
    zero."""
    k = torch.arange(1, 3 * 3 * 3 * 1 * 8 + 1, dtype=torch.float32).reshape(3, 3, 3, 1, 8)
    wt = cuda_conv.cin1_weights(k)
    assert tuple(wt.shape) == (32, 8) and wt.is_contiguous() and wt.dtype == k.dtype
    for kz, ky, kx, co in [(0, 0, 0, 0), (2, 1, 0, 7), (1, 2, 2, 3), (2, 2, 2, 5)]:
        assert wt[(kz * 3 + ky) * 3 + kx, co] == k[kz, ky, kx, 0, co]
    assert bool((wt[27:] == 0).all()) and bool((wt[:27] != 0).all())


@pytest.mark.parametrize("route,dtype", [("sm90", torch.bfloat16), ("wmma", torch.bfloat16),
                                         ("f32", torch.float32)])
def test_stores_only_build_is_the_cin1_kernels(route, dtype):
    """Only the cin1 kernel has a stores-only measurement build."""
    x, k, _ = _inputs((1, 3, 4, 5, 1), 32)
    with pytest.raises(ValueError, match="stores-only"):
        cuda_conv.launch(torch.tensor(x).to(dtype), torch.tensor(k).to(dtype), route=route, stores_only=True)


@pytest.mark.parametrize("route,dtype", [("sm90", torch.bfloat16), ("wmma", torch.bfloat16),
                                         ("f32", torch.float32)])
def test_general_build_is_the_cin1_kernels(route, dtype):
    """Only the cin1 kernel has a general-path measurement build."""
    x, k, _ = _inputs((1, 3, 4, 5, 1), 32)
    with pytest.raises(ValueError, match="general"):
        cuda_conv.launch(torch.tensor(x).to(dtype), torch.tensor(k).to(dtype), route=route, general=True)


def test_cin1_launcher_refuses_f32_operands():
    x, k, _ = _inputs((1, 3, 4, 5, 1), 32)
    with pytest.raises(ValueError, match="route"):
        cuda_conv.launch(torch.tensor(x), torch.tensor(k), route="cin1")


def test_cpu_conv_launches_no_kernel():
    x, k, b = _inputs((1, 3, 4, 5, 16), 64)
    cuda_conv.reset_launches()
    cuda_conv.conv3d(torch.tensor(x).to(torch.bfloat16), torch.tensor(k).to(torch.bfloat16), torch.tensor(b))
    assert cuda_conv.conv3d.launches == 0
    assert all(getattr(cuda_conv.conv3d, f"launches_{r}") == 0 for r in cuda_conv.ROUTES)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorded_stage_convs():
    """(x shape, DHWIO kernel shape) of each 3x3x3 conv of the shipped
    GradICON's finest stage, in call order, recorded from the port's stage
    UNet run on meta tensors at the shipped grid (no arithmetic)."""
    from oai_analysis_2_tpu_torch.models.gradicon import load_gradicon_checkpoint

    params, meta = load_gradicon_checkpoint()
    net = T.UNet3D(_stage_spec(meta["stage_width"]), torch.float32, device="meta")
    calls = []

    def record(x, kernel, bias=None, *, relu=False, out_dtype=None):
        calls.append((tuple(x.shape), tuple(kernel.shape)))
        return torch.empty(tuple(x.shape[:-1]) + (kernel.shape[-1],), device=x.device)

    orig = T.conv3d
    T.conv3d = record
    try:
        net(torch.empty((1,) + tuple(meta["grid_shape"]) + (2,), device="meta"))
    finally:
        T.conv3d = orig
    return params[-1], calls


def test_chip_smoke_times_enc0a_on_the_cin1_route():
    """chip_smoke.py's enc0a row is the production UNet's first conv at the
    slab shape, and the source it names is the cin1 kernel's."""
    mod = _chip_smoke()
    (name, shape, cin, cout), = [c for c in mod.SEG_CONVS if c[0] == "enc0a"]
    kshape = dict(SEGMENT_CONVS)["enc0a"]
    assert (cin, cout) == (kshape[3], kshape[4]) and shape == mod.SLAB
    route = cuda_conv.conv3d_route(cin, cout, torch.bfloat16)
    assert route == "cin1" and mod.CONV_SOURCES[route].endswith("csrc/conv3d_cin1.cu")


def test_chip_smoke_times_gradicon_enc0a_on_the_cinsmall_route():
    """chip_smoke.py's cinsmall row is the shipped GradICON's finest-stage
    enc0a (2 -> 24 at 1x48x96x96), and the source it names is the cinsmall
    kernel's."""
    mod = _chip_smoke()
    (name, shape, cin, cout), = [c for c in mod.gradicon_convs() if c[0].endswith("enc0a")]
    assert mod.CINSMALL_CONV == ("gradicon.stage2.enc0a", shape, cin, cout)
    assert (shape, cin, cout) == ((1, 48, 96, 96), 2, 24)
    route = cuda_conv.conv3d_route(cin, cout, torch.bfloat16)
    assert route == "cinsmall" and mod.CONV_SOURCES[route].endswith("csrc/conv3d_cinsmall.cu")


def test_every_conv_route_source_is_built():
    """Each route's source in chip_smoke.py exists and is one of the
    libraries that `cuda_build.build_all` compiles."""
    from pathlib import Path

    from oai_analysis_2_tpu_torch.ops import cuda_build

    root = Path(__file__).resolve().parents[1]
    for route in cuda_conv.ROUTES:
        src = root / _chip_smoke().CONV_SOURCES[route]
        assert src.is_file() and src.stem in cuda_build.EXTRA_FLAGS


STAGE2_NAMES = [n for n, _ in GRADICON_CONVS]


@pytest.mark.parametrize("index", range(len(STAGE2_NAMES)), ids=STAGE2_NAMES)
def test_chip_smoke_times_the_real_gradicon_convs(index):
    """chip_smoke.py's f32 shapes are the shipped stage-2 convs at the grid
    sizes the stage UNet gives them: Cin and Cout as in the weights file
    (dec1a is 144 -> 48, upconv 96 + skip 48), x as recorded from a run."""
    name, shape, cin, cout = _chip_smoke().gradicon_convs()[index]
    stage_params, calls = _recorded_stage_convs()
    x_shape, kshape = calls[index]
    assert name == f"stage2.{STAGE2_NAMES[index]}"
    assert tuple(np.shape(stage_params[STAGE2_NAMES[index]]["kernel"])) == kshape == (3, 3, 3, cin, cout)
    assert x_shape == shape + (cin,)


@pytest.mark.parametrize("cout,voxels,want", [
    (24, 442368, (512, 24, 1)), (48, 442368, (256, 48, 1)), (96, 55296, (128, 96, 1)),
    (48, 55296, (128, 48, 1)), (192, 6912, (64, 96, 2)), (96, 6912, (64, 96, 4)), (24, 55296, (256, 24, 2)),
    (7, 442368, (512, 24, 1)), (72, 1000, (256, 24, 2)), (100, 442368, (512, 24, 1)),
])
def test_f32_tile_choice(cout, voxels, want):
    """BN pads Cout least (24, 48, 96 and 192 not at all) and BM * BN =
    12288; under 264 blocks (two per SM) BM halves, and then under 264
    blocks K splits in 2 groups, under 132 in 4 (2 at BN = 24)."""
    assert cuda_conv.f32_tile(cout, voxels) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_f32_was_launcher_refuses_other_types(dtype):
    x, k, _ = _inputs((1, 3, 4, 5, 16), 48)
    with pytest.raises(ValueError, match="route"):
        cuda_conv.launch(torch.tensor(x).to(dtype), torch.tensor(k).to(dtype), route="f32_was")


def test_f32_was_launcher_refuses_cpu_tensors():
    x, k, _ = _inputs((1, 3, 4, 5, 16), 48)
    with pytest.raises(ValueError, match="device"):
        cuda_conv.launch(torch.tensor(x), torch.tensor(k), route="f32_was")


@pytest.mark.parametrize("route", ["sm90", "wmma", "cin1"])
def test_compute_only_build_is_the_f32_kernels(route):
    """Only the f32 kernel has a compute-only measurement build."""
    x, k, _ = _inputs((1, 3, 4, 5, 16), 64)
    with pytest.raises(ValueError, match="compute-only"):
        cuda_conv.launch(torch.tensor(x).to(torch.bfloat16), torch.tensor(k).to(torch.bfloat16), route=route,
                         compute_only=True)
