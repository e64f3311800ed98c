"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs an NVIDIA card (marker `cuda`) and skips
without one. This file imports no JAX, so it also runs on a machine that
has PyTorch with CUDA and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu_torch.ops import cuda_conv, cuda_kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (x shape, Cout): ragged channels, Cin = 1 as in enc0a, a batch of 2, a
# Cout above one 64-channel block
CONV_CASES = [((1, 6, 8, 10, 5), 7), ((2, 4, 6, 8, 16), 8), ((1, 5, 7, 6, 1), 3), ((1, 4, 5, 6, 8), 72)]


@pytest.mark.parametrize("shape,cout", CONV_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("use_bias,relu", [(True, True), (False, False)])
def test_conv_kernel_matches_plain(card, shape, cout, dtype, tol, use_bias, relu):
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=card).to(dtype)
    k = torch.tensor(rng.normal(0, 0.2, (3, 3, 3, shape[-1], cout)).astype(np.float32), device=card).to(dtype)
    b = torch.tensor(rng.normal(0, 0.5, (cout,)).astype(np.float32), device=card) if use_bias else None
    before = cuda_conv.conv3d.launches
    got = cuda_conv.conv3d(x, k, b, relu=relu, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert cuda_conv.conv3d.launches == before + 1
    want = cuda_conv.conv3d_reference(x, k, b, relu=relu, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    # the output cast is one rounding of the same f32 epilogue value
    got_cast = cuda_conv.conv3d(x, k, b, relu=relu, out_dtype=dtype)
    assert got_cast.dtype == dtype
    torch.testing.assert_close(got_cast.float(), got.to(dtype).float(), atol=tol, rtol=tol)


# (x shape, Cout) for the TMA + wgmma route (bf16, Cin % 16 == 0, Cout % 64
# == 0): 32-channel chunks (enc0b), 64-channel chunks, 3 and 12 chunks per
# tap, 16-channel chunks, Cin 96 as 32-channel chunks; Cout 64 (one 64-wide
# block), 128 and 256 (128-wide blocks), 192 (three 64-wide blocks);
# spatial sizes that no box divides, a batch of 2, a single z plane (both
# out-of-volume z taps skipped)
SM90_CASES = [
    ((1, 5, 7, 37, 32), 64),
    ((2, 3, 13, 50, 64), 128),
    ((1, 5, 7, 37, 192), 256),
    ((1, 3, 13, 50, 768), 64),
    ((2, 4, 9, 20, 32), 128),
    ((1, 6, 17, 40, 16), 64),
    ((1, 1, 8, 32, 64), 64),
    ((1, 4, 10, 70, 96), 192),
]


@pytest.mark.parametrize("shape,cout", SM90_CASES)
@pytest.mark.parametrize("use_bias,relu", [(True, True), (False, False)])
def test_sm90_conv_matches_plain(card, shape, cout, use_bias, relu):
    cin = shape[-1]
    assert cuda_conv.conv3d_route(cin, cout, torch.bfloat16) == "sm90"
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=card).to(torch.bfloat16)
    k = torch.tensor(rng.normal(0, 1, (3, 3, 3, cin, cout)).astype(np.float32) / np.sqrt(27 * cin),
                     device=card).to(torch.bfloat16)
    b = torch.tensor(rng.normal(0, 0.5, (cout,)).astype(np.float32), device=card) if use_bias else None
    before, before_sm90 = cuda_conv.conv3d.launches, cuda_conv.conv3d.launches_sm90
    got = cuda_conv.conv3d(x, k, b, relu=relu, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert cuda_conv.conv3d.launches == before + 1
    assert cuda_conv.conv3d.launches_sm90 == before_sm90 + 1
    want = cuda_conv.conv3d_reference(x, k, b, relu=relu, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    got_bf16 = cuda_conv.conv3d(x, k, b, relu=relu, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert cuda_conv.conv3d.launches_sm90 == before_sm90 + 2
    assert got_bf16.dtype == torch.bfloat16
    torch.testing.assert_close(got_bf16.float(), got.to(torch.bfloat16).float(), atol=2e-2, rtol=2e-2)


def test_uncounted_launches_at_an_sm90_shape(card):
    """The measurements' launches: the wmma build at an sm90 shape agrees
    with the sm90 route, the loads-only build runs to its end, and neither
    moves a launch count."""
    shape, cout = (1, 5, 7, 37, 64), 128
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=card).to(torch.bfloat16)
    k = torch.tensor(rng.normal(0, 1, (3, 3, 3, 64, cout)).astype(np.float32) / np.sqrt(27 * 64),
                     device=card).to(torch.bfloat16)
    b = torch.tensor(rng.normal(0, 0.5, (cout,)).astype(np.float32), device=card)
    want = cuda_conv.conv3d(x, k, b, relu=True, out_dtype=torch.float32)
    before = {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES}
    got = cuda_conv.launch(x, k, b, route="wmma", relu=True, out_dtype=torch.float32)
    cuda_conv.launch(x, k, b, route="sm90", relu=True, out_dtype=torch.float32, loads_only=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    assert {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES} == before


def test_sm90_conv_refuses_misaligned_input(card):
    """A storage offset of one bf16 element breaks TMA's 16-byte alignment:
    the wrapper raises, it does not fall back to another kernel."""
    shape = (1, 3, 5, 9, 64)
    base = torch.zeros(int(np.prod(shape)) + 1, device=card, dtype=torch.bfloat16)
    x = base[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    k = torch.zeros((3, 3, 3, 64, 64), device=card, dtype=torch.bfloat16)
    before = {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES}
    with pytest.raises(ValueError, match="aligned"):
        cuda_conv.conv3d(x, k)
    assert {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES} == before


# (x shape, Cout) for the sm90n route (bf16, Cin % 8 == 0, not an sm90 or
# cin1 shape). The GradICON stage convs' channel pairs, forward (24->48,
# 48->48, 48->96, 96->96, 288->96, 144->48) and data gradient (24->2,
# 48->24, 96->48, 192->96, 96->288, 48->144), and the UNet's enc0b data
# gradient (64->32); Cout 2, 7 and 8 (one N = 8 tile, element stores at
# Cout 2 and 7), 24, 144, 288 (two 144-wide n-tiles) and 1000 (four
# 256-wide); Cin 8 and 24 (chunks that TMA zero-fills past Cin); 16-, 32-
# and 64-channel chunks; one m64 tile a consumer at the small grids, three
# (two at N = 144) at the 24x48x96 ones; D, H and W that no box divides, a
# batch of 2, a single z plane
SM90N_CASES = [
    ((1, 3, 9, 37, 24), 48),
    ((1, 3, 8, 40, 48), 48),
    ((2, 3, 8, 24, 48), 96),
    ((1, 2, 8, 96, 96), 96),
    ((1, 3, 7, 20, 288), 96),
    ((1, 3, 9, 50, 144), 48),
    ((1, 3, 9, 37, 24), 2),
    ((1, 3, 9, 37, 48), 24),
    ((1, 4, 8, 48, 96), 48),
    ((1, 3, 8, 40, 192), 96),
    ((1, 3, 8, 48, 96), 288),
    ((2, 3, 9, 33, 48), 144),
    ((1, 2, 8, 96, 48), 144),
    ((2, 2, 8, 128, 64), 32),
    ((1, 5, 6, 10, 8), 8),
    ((1, 1, 8, 16, 16), 24),
    ((2, 3, 5, 7, 24), 7),
    ((1, 3, 6, 11, 8), 64),
    ((1, 2, 8, 16, 16), 1000),
    ((1, 24, 48, 96, 144), 48),
    ((1, 24, 48, 96, 48), 144),
    ((1, 24, 48, 96, 64), 32),
    ((1, 24, 48, 96, 96), 288),
    ((1, 23, 45, 94, 24), 2),
]


@pytest.mark.parametrize("shape,cout", SM90N_CASES)
@pytest.mark.parametrize("use_bias,relu", [(True, True), (False, False), (True, False)])
def test_sm90n_conv_matches_plain(card, shape, cout, use_bias, relu):
    cin = shape[-1]
    assert cuda_conv.conv3d_route(cin, cout, torch.bfloat16) == "sm90n"
    rng = np.random.default_rng(17)
    x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=card).to(torch.bfloat16)
    k = torch.tensor(rng.normal(0, 1, (3, 3, 3, cin, cout)).astype(np.float32) / np.sqrt(27 * cin),
                     device=card).to(torch.bfloat16)
    b = torch.tensor(rng.normal(0, 0.5, (cout,)).astype(np.float32), device=card) if use_bias else None
    before, before_n = cuda_conv.conv3d.launches, cuda_conv.conv3d.launches_sm90n
    got = cuda_conv.conv3d(x, k, b, relu=relu, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert cuda_conv.conv3d.launches == before + 1
    assert cuda_conv.conv3d.launches_sm90n == before_n + 1
    want = cuda_conv.conv3d_reference(x, k, b, relu=relu, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    got_bf16 = cuda_conv.conv3d(x, k, b, relu=relu, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert cuda_conv.conv3d.launches_sm90n == before_n + 2
    assert got_bf16.dtype == torch.bfloat16
    torch.testing.assert_close(got_bf16.float(), got.to(torch.bfloat16).float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("shape,cout", [((1, 3, 9, 37, 144), 48), ((1, 3, 9, 37, 24), 2)])
def test_sm90n_uncounted_launches(card, shape, cout):
    """The measurements' launches at sm90n shapes: the wmma build agrees
    with the sm90n route, the loads-only build runs to its end, and neither
    moves a launch count."""
    cin = shape[-1]
    rng = np.random.default_rng(19)
    x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=card).to(torch.bfloat16)
    k = torch.tensor(rng.normal(0, 1, (3, 3, 3, cin, cout)).astype(np.float32) / np.sqrt(27 * cin),
                     device=card).to(torch.bfloat16)
    b = torch.tensor(rng.normal(0, 0.5, (cout,)).astype(np.float32), device=card)
    want = cuda_conv.conv3d(x, k, b, relu=True, out_dtype=torch.float32)
    before = {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES}
    got = cuda_conv.launch(x, k, b, route="wmma", relu=True, out_dtype=torch.float32)
    cuda_conv.launch(x, k, b, route="sm90n", relu=True, out_dtype=torch.bfloat16, loads_only=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    assert {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES} == before


def test_sm90n_conv_refuses_misaligned_input(card):
    """A storage offset of one bf16 element breaks TMA's 16-byte alignment:
    the wrapper raises, it does not fall back to another kernel."""
    shape = (1, 3, 5, 9, 24)
    base = torch.zeros(int(np.prod(shape)) + 1, device=card, dtype=torch.bfloat16)
    x = base[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    k = torch.zeros((3, 3, 3, 24, 48), device=card, dtype=torch.bfloat16)
    before = {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES}
    with pytest.raises(ValueError, match="aligned"):
        cuda_conv.conv3d(x, k)
    assert {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES} == before


# x shapes (B, D, H, W) for the cin1 route (bf16, Cin = 1). W = 41 and 130
# (rows not a multiple of 16 bytes) take the cp.async box and W = 64 and 600
# the TMA box; ragged sizes, batches of 2, rows cut into x chunks that do
# not divide W (W = 130 at Cout 64, W = 600 at every Cout); no shape is a
# multiple of its tile. Cout 8, 16, 32 and 64 store bf16 by TMA, the odd
# and other widths (24, 40, 48, 56) by bulk rows; every Cout is its own
# instantiation of the kernel
CIN1_COUTS = [8, 16, 24, 32, 40, 48, 56, 64]
CIN1_SHAPES = [(1, 5, 37, 41), (2, 7, 9, 130), (1, 3, 5, 600), (2, 3, 11, 64)]


def _cin1_inputs(card, shape, cout, use_bias, seed=31):
    rng = np.random.default_rng(seed + cout)
    x = torch.tensor(rng.normal(0, 1, shape + (1,)).astype(np.float32), device=card).to(torch.bfloat16)
    k = torch.tensor((rng.normal(0, 1, (3, 3, 3, 1, cout)) / np.sqrt(27)).astype(np.float32),
                     device=card).to(torch.bfloat16)
    b = torch.tensor(rng.normal(0, 0.5, (cout,)).astype(np.float32), device=card) if use_bias else None
    return x, k, b


@pytest.mark.parametrize("cout", CIN1_COUTS)
@pytest.mark.parametrize("shape", CIN1_SHAPES)
@pytest.mark.parametrize("use_bias,relu", [(True, True), (False, False)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_cin1_conv_matches_plain(card, cout, shape, use_bias, relu, out_dtype):
    assert cuda_conv.conv3d_route(1, cout, torch.bfloat16) == "cin1"
    x, k, b = _cin1_inputs(card, shape, cout, use_bias)
    before, before_cin1 = cuda_conv.conv3d.launches, cuda_conv.conv3d.launches_cin1
    got = cuda_conv.conv3d(x, k, b, relu=relu, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert cuda_conv.conv3d.launches == before + 1
    assert cuda_conv.conv3d.launches_cin1 == before_cin1 + 1
    assert got.dtype == out_dtype
    want = cuda_conv.conv3d_reference(x, k, b, relu=relu, out_dtype=torch.float32)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
    if out_dtype == torch.bfloat16:
        # the bf16 output is the single rounding of the kernel's f32 result
        got_f32 = cuda_conv.conv3d(x, k, b, relu=relu, out_dtype=torch.float32)
        torch.testing.assert_close(got.float(), got_f32.to(torch.bfloat16).float(), atol=0, rtol=0)


# one step of the knee batch (16 tiles of 32x128x128: 8 tiles x 2 knees, the
# training tiling that two full-size knees take) at enc0b and enc3b (sm90)
# and enc0a (cin1): the batch against the plain version, and tiles 0, 7 and
# 15 bit-equal to the kernel on that tile alone (the batch index is the
# grid's z)
BATCH_TILE_CASES = [((16, 32, 128, 128, 32), 64), ((16, 4, 16, 16, 512), 512), ((16, 32, 128, 128, 1), 32)]


@pytest.mark.parametrize("shape,cout", BATCH_TILE_CASES)
def test_bf16_routes_at_the_knee_batch_tiles(card, shape, cout):
    cin = shape[-1]
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=card).to(torch.bfloat16)
    k = torch.tensor((rng.normal(0, 1, (3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32),
                     device=card).to(torch.bfloat16)
    b = torch.tensor(rng.normal(0, 0.5, (cout,)).astype(np.float32), device=card)
    got = cuda_conv.conv3d(x, k, b, relu=True, out_dtype=torch.float32)
    want = cuda_conv.conv3d_reference(x, k, b, relu=True, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    for i in (0, 7, 15):
        alone = cuda_conv.conv3d(x[i : i + 1], k, b, relu=True, out_dtype=torch.float32)
        torch.testing.assert_close(got[i : i + 1], alone, atol=0, rtol=0)


def test_cin1_uncounted_launches(card):
    """The measurements' launches at a cin1 shape: the wmma build agrees
    with the cin1 route, the stores-only build writes relu(bias) everywhere,
    and neither moves a launch count."""
    x, k, b = _cin1_inputs(card, (1, 5, 37, 41), 32, True)
    want = cuda_conv.conv3d(x, k, b, relu=True, out_dtype=torch.float32)
    before = {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES}
    total = cuda_conv.conv3d.launches
    got = cuda_conv.launch(x, k, b, route="wmma", relu=True, out_dtype=torch.float32)
    stores = cuda_conv.launch(x, k, b, route="cin1", relu=True, out_dtype=torch.bfloat16, stores_only=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(stores.float(), torch.relu(b).to(torch.bfloat16).float().expand_as(stores),
                               atol=0, rtol=0)
    assert {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES} == before
    assert cuda_conv.conv3d.launches == total


@pytest.mark.parametrize("cout", [8, 32, 64])
@pytest.mark.parametrize("shape", [(2, 3, 11, 64), (1, 3, 5, 600)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_cin1_general_build_agrees(card, cout, shape, out_dtype):
    """At shapes that take the TMA landing (and, for bf16 output, the TMA
    store), the general build (cp.async landing, bulk row stores) gives the
    same bits, uncounted."""
    x, k, b = _cin1_inputs(card, shape, cout, True)
    want = cuda_conv.conv3d(x, k, b, relu=True, out_dtype=out_dtype)
    before = {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES}
    got = cuda_conv.launch(x, k, b, route="cin1", relu=True, out_dtype=out_dtype, general=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES} == before


def test_cin1_conv_refuses_misaligned_input(card):
    """A storage offset of one bf16 element breaks the 16-byte alignment of
    the box's copies: the wrapper raises, it does not fall back to another
    kernel."""
    shape = (1, 3, 5, 64, 1)
    base = torch.zeros(int(np.prod(shape)) + 1, device=card, dtype=torch.bfloat16)
    x = base[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    k = torch.zeros((3, 3, 3, 1, 32), device=card, dtype=torch.bfloat16)
    before = {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES}
    with pytest.raises(ValueError, match="aligned"):
        cuda_conv.conv3d(x, k)
    assert {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES} == before


@pytest.mark.parametrize("cout,dtype", [(12, torch.bfloat16), (72, torch.bfloat16), (32, torch.float32)])
def test_cin1_launcher_refuses_other_shapes(card, cout, dtype):
    """Cout = 12 (not a multiple of 8), Cout = 72 (above 64) and f32
    operands raise; nothing falls back to the wmma build."""
    x = torch.zeros((1, 3, 5, 9, 1), device=card, dtype=dtype)
    k = torch.zeros((3, 3, 3, 1, cout), device=card, dtype=dtype)
    with pytest.raises(ValueError, match="cin1|route"):
        cuda_conv.launch(x, k, route="cin1")


def test_conv_kernel_refuses_bad_input(card):
    x = torch.zeros((1, 4, 4, 4, 3), device=card)
    with pytest.raises(TypeError):
        cuda_conv.conv3d(x, torch.zeros((3, 3, 3, 3, 2), device=card, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        cuda_conv.conv3d(x, torch.zeros((3, 3, 3, 4, 2), device=card))
    with pytest.raises(ValueError):
        cuda_conv.conv3d(x.transpose(1, 2), torch.zeros((3, 3, 3, 3, 2), device=card))


def _soup(seed, n_tri, n_pts):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(0, 10, (n_tri * 3, 3)).astype(np.float32)
    verts[3:6] = verts[3]  # a point-triangle
    verts[7] = verts[6]  # a segment-triangle
    points = rng.uniform(-2, 12, (n_pts, 3)).astype(np.float32)
    points[:3] = verts[:3]  # on a corner
    return verts.reshape(-1, 9), points


@pytest.mark.parametrize("seed,n_tri,n_pts", [(0, 300, 700), (5, 5000, 3000), (6, 3, 3), (7, 513, 129)])
def test_distance_kernel_matches_plain(card, seed, n_tri, n_pts):
    tris, points = _soup(seed, n_tri, n_pts)
    p = torch.tensor(points, device=card)
    t = torch.tensor(tris, device=card)
    before = cuda_kernels.point_triangle_min_d2.launches
    got = cuda_kernels.point_triangle_distance(p, t)
    torch.cuda.synchronize()
    assert cuda_kernels.point_triangle_min_d2.launches == before + 1
    want = torch.sqrt(cuda_kernels.point_triangle_min_d2_reference(p, t))
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


# every channel pair of the width-24 GradICON stage UNets, on small ragged
# grids: a batch of 2, and a single z plane (both out-of-volume z taps)
F32_PAIRS = [(2, 24), (24, 48), (48, 48), (144, 48), (48, 96), (288, 96), (96, 96), (96, 192)]
F32_GRIDS = [(2, 3, 7, 9), (1, 1, 6, 13)]


@pytest.mark.parametrize("cin,cout", F32_PAIRS)
@pytest.mark.parametrize("grid", F32_GRIDS)
@pytest.mark.parametrize("use_bias,relu", [(True, True), (False, False)])
def test_f32_conv_matches_plain_at_gradicon_widths(card, cin, cout, grid, use_bias, relu):
    assert cuda_conv.conv3d_route(cin, cout, torch.float32) == "f32"
    rng = np.random.default_rng(cin * 1000 + cout)
    x = torch.tensor(rng.normal(0, 1, grid + (cin,)).astype(np.float32), device=card)
    k = torch.tensor((rng.normal(0, 1, (3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32), device=card)
    b = torch.tensor(rng.normal(0, 0.5, (cout,)).astype(np.float32), device=card) if use_bias else None
    before = cuda_conv.conv3d.launches_f32
    got = cuda_conv.conv3d(x, k, b, relu=relu)
    torch.cuda.synchronize()
    assert cuda_conv.conv3d.launches_f32 == before + 1
    want = cuda_conv.conv3d_reference(x, k, b, relu=relu)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    got_bf16 = cuda_conv.conv3d(x, k, b, relu=relu, out_dtype=torch.bfloat16)
    torch.testing.assert_close(got_bf16.float(), got.to(torch.bfloat16).float(), atol=1e-2, rtol=1e-2)


def test_f32_was_build_agrees_uncounted(card):
    """The build that the f32 route replaced, reached only through
    `launch(route="f32_was")`: it agrees with the route's kernel and moves
    no launch count."""
    rng = np.random.default_rng(17)
    x = torch.tensor(rng.normal(0, 1, (2, 3, 7, 9, 48)).astype(np.float32), device=card)
    k = torch.tensor(rng.normal(0, 0.05, (3, 3, 3, 48, 96)).astype(np.float32), device=card)
    b = torch.tensor(rng.normal(0, 0.5, (96,)).astype(np.float32), device=card)
    want = cuda_conv.conv3d(x, k, b, relu=True)
    before = {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES}
    total = cuda_conv.conv3d.launches
    got = cuda_conv.launch(x, k, b, route="f32_was", relu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert {r: getattr(cuda_conv.conv3d, f"launches_{r}") for r in cuda_conv.ROUTES} == before
    assert cuda_conv.conv3d.launches == total


def _check_distance(card, tris, points):
    p = torch.tensor(points, device=card)
    t = torch.tensor(tris, device=card)
    before = cuda_kernels.point_triangle_min_d2.launches
    got = cuda_kernels.point_triangle_distance(p, t)
    torch.cuda.synchronize()
    assert cuda_kernels.point_triangle_min_d2.launches == before + 1
    want = torch.sqrt(cuda_kernels.point_triangle_min_d2_reference(p, t))
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("n_pts", [1, 33, 129, 1000])
def test_distance_kernel_at_ragged_point_counts(card, n_pts):
    """Point counts that leave a thread's 4 points, or a block's 512, part
    empty."""
    tris, points = _soup(n_pts, 700, max(n_pts, 3))
    _check_distance(card, tris, points[:n_pts])


def test_distance_kernel_at_knee_coordinates(card):
    """A small-triangle surface 150 mm from the origin (knee-like
    coordinates), points on its edges and corners and just off them, and
    degenerate triangles (a point, a segment, collinear corners)."""
    rng = np.random.default_rng(23)
    n_tri = 2000
    corner = rng.uniform(0, 40, (n_tri, 1, 3)) + 150.0
    tris = (corner + rng.normal(0, 0.5, (n_tri, 3, 3))).astype(np.float32)
    tris[1] = tris[1, 0]  # a point
    tris[2, 1] = tris[2, 0]  # a segment
    tris[3, 2] = 2 * tris[3, 1] - tris[3, 0]  # collinear corners
    w = rng.uniform(0, 1, (n_tri, 1)).astype(np.float32)
    on_edge = w * tris[:, 0] + (1 - w) * tris[:, 1]
    points = np.concatenate([
        tris[:300].reshape(-1, 3),  # corners
        on_edge[:600],  # on edges
        on_edge[600:900] + rng.normal(0, 1e-3, (300, 3)).astype(np.float32),  # just off them
        (corner[:500, 0] + rng.normal(0, 2.0, (500, 3))).astype(np.float32),  # around the surface
    ]).astype(np.float32)
    _check_distance(card, tris.reshape(-1, 9), points)


def test_distance_was_build_agrees_uncounted(card):
    """The build that the distance kernel replaced, reached only through
    `point_triangle_launch(build="was")`: it agrees with the kernel and
    moves no launch count."""
    tris, points = _soup(29, 1500, 900)
    p, t = torch.tensor(points, device=card), torch.tensor(tris, device=card)
    want = cuda_kernels.point_triangle_min_d2(p, t)
    before = cuda_kernels.point_triangle_min_d2.launches
    got = cuda_kernels.point_triangle_launch(p, t, build="was")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.sqrt(), want.sqrt(), atol=1e-3, rtol=1e-4)
    assert cuda_kernels.point_triangle_min_d2.launches == before


# the conv under autograd (`Conv3dFn`): (x shape, Cout, dtype) on every
# route a trainer's forward or data gradient takes: wmma both ways (ragged
# at B = 2), the GradICON enc0a (wmma forward 2 -> 24, sm90n data gradient
# 24 -> 2), its dec1a (sm90n both ways, 144 -> 48 and 48 -> 144), the
# UNet's enc0b (sm90 forward 32 -> 64, sm90n data gradient 64 -> 32), sm90
# both ways at B = 2, cin1 forward (Cin = 1: no data gradient), f32 both
# ways
TRAIN_CASES = [
    ((2, 4, 6, 8, 5), 7, torch.bfloat16),
    ((1, 4, 8, 16, 2), 24, torch.bfloat16),
    ((1, 4, 8, 32, 144), 48, torch.bfloat16),
    ((2, 4, 8, 32, 32), 64, torch.bfloat16),
    ((2, 4, 8, 32, 64), 64, torch.bfloat16),
    ((2, 4, 8, 32, 1), 32, torch.bfloat16),
    ((2, 4, 6, 8, 5), 7, torch.float32),
    ((1, 4, 8, 16, 24), 48, torch.float32),
]


@pytest.mark.parametrize("shape,cout,dtype", TRAIN_CASES)
@pytest.mark.parametrize("use_bias,relu", [(True, True), (False, False)])
def test_conv_train_matches_plain_on_card(card, shape, cout, dtype, use_bias, relu):
    """Forward, dx, dW and db against autograd through the plain version
    (bf16 2e-2, f32 1e-4; dW and db against their largest element); the
    data gradient launches the kernel of its swapped channels' route and
    counts apart; an input without requires_grad takes no data gradient."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    rng = np.random.default_rng(31)
    cin = shape[-1]
    x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=card).to(dtype)
    k = torch.tensor(rng.normal(0, 1, (3, 3, 3, cin, cout)).astype(np.float32) / np.sqrt(27 * cin),
                     device=card).to(dtype)
    b = torch.tensor(rng.normal(0, 0.5, (cout,)).astype(np.float32), device=card) if use_bias else None
    pre = cuda_conv.conv3d_reference(x, k, b, out_dtype=torch.float32)
    # no output gradient within 1e-3 of the ReLU kink, where the two sums may pick another side
    dy = (torch.tensor(rng.normal(0, 1, shape[:-1] + (cout,)).astype(np.float32), device=card)
          * (pre.abs() > 1e-3)).to(dtype)
    need_dx = cin > 1

    def grads(fn):
        leaves = [x.clone().requires_grad_(need_dx), k.clone().requires_grad_()]
        if use_bias:
            leaves.append(b.clone().requires_grad_())
        out = fn(leaves[0], leaves[1], leaves[2] if use_bias else None, relu=relu, out_dtype=dtype)
        return [out.detach()] + list(torch.autograd.grad(out, leaves if need_dx else leaves[1:], dy))

    cuda_conv.reset_launches()
    got = grads(cuda_conv.conv3d_train)
    torch.cuda.synchronize()
    droute = cuda_conv.conv3d_route(cout, cin, dtype)
    assert cuda_conv.conv3d.launches == 1 + need_dx
    assert cuda_conv.conv3d.launches_dgrad == getattr(cuda_conv.conv3d, f"launches_dgrad_{droute}") == need_dx
    want = grads(cuda_conv.conv3d_reference)
    assert cuda_conv.conv3d.launches == 1 + need_dx  # the plain version launches nothing
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
    if need_dx:
        torch.testing.assert_close(got[1].float(), want[1].float(), atol=tol, rtol=tol)
    for g, w in zip(got[1 + need_dx:], want[1 + need_dx:]):
        assert g.dtype == w.dtype and g.is_cuda
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float() / scale, w.float() / scale, atol=tol, rtol=tol)


def test_unet_train_step_card_matches_cpu(card):
    """One f32 Adam step of `make_train_step` on UNet_light4 (f32 route
    forward and data gradient) on the card and on the CPU from the same
    params: the loss within 1e-5 relative, gradients within 1e-4 of each
    leaf's largest."""
    from oai_analysis_2_tpu_torch.engine.training import make_train_step
    from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS, UNet3D
    from oai_analysis_2_tpu_torch.utils import optim
    from oai_analysis_2_tpu_torch.utils.checkpoint import carry_params, export_params

    spec = NETWORK_SPECS["UNet_light4"].replace(bias=True)
    params = export_params(UNet3D(spec, device="cpu").init(torch.Generator().manual_seed(4)))
    rng = np.random.default_rng(4)
    images = rng.uniform(0, 1, (2, 8, 16, 16, 1)).astype(np.float32)
    labels = (rng.uniform(0, 1, (2, 8, 16, 16, 2)) > 0.6).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        model = UNet3D(spec, device=dev)
        carry_params(model, params)
        loss = make_train_step(model, optim.adam(list(model.parameters()), 1e-3))(images, labels)
        out[dev] = (float(loss), {n: p.grad.cpu() for n, p in model.named_parameters()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for n, g in out["cpu"][1].items():
        scale = float(g.abs().max())
        torch.testing.assert_close(out["cuda"][1][n] / scale, g / scale, atol=1e-4, rtol=1e-4)
