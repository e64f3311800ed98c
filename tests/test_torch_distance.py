"""The PyTorch port's point-to-triangle distance against the JAX package.

The port's plain version (what its kernel wrapper runs for CPU tensors) is
held against `mesh/ops.distance_to_surface` (the XLA path) and against the
Pallas `_dist_kernel` in interpret mode, patched in as
tests/test_pallas_kernels.py does. The kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu.mesh.ops import distance_to_surface
from oai_analysis_2_tpu.mesh.types import Mesh as JMesh
from oai_analysis_2_tpu_torch.mesh import ops as tops
from oai_analysis_2_tpu_torch.mesh.types import Mesh
from oai_analysis_2_tpu_torch.ops import cuda_kernels

torch.set_num_threads(2)


def _soup(seed, n_tri=300, n_pts=700):
    """A triangle soup with degenerate members and points around it."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(0, 10, (n_tri * 3, 3)).astype(np.float32)
    verts[3:6] = verts[3]  # a point-triangle
    verts[7] = verts[6]  # a segment-triangle
    faces = np.arange(n_tri * 3, dtype=np.int32).reshape(-1, 3)
    points = rng.uniform(-2, 12, (n_pts, 3)).astype(np.float32)
    points[:3] = verts[:3]  # on a corner
    return verts, faces, points


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_xla_distance(seed):
    verts, faces, points = _soup(seed)
    want = distance_to_surface(points, JMesh(verts, faces), force_xla=True)
    got = tops.distance_to_surface(points, Mesh(verts, faces), device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_plain_matches_pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    import oai_analysis_2_tpu.ops.pallas_kernels as pk

    verts, faces, points = _soup(2, n_tri=600, n_pts=300)
    orig_call = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig_call(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    pk._distance_pallas.clear_cache()
    want = pk.point_triangle_distance_pallas(points, JMesh(verts, faces).triangles())
    pk._distance_pallas.clear_cache()
    got = cuda_kernels.point_triangle_distance(
        torch.tensor(points), torch.tensor(verts[faces].reshape(-1, 9)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_plain_chunking_is_exact():
    verts, faces, points = _soup(3, n_tri=257, n_pts=130)
    p, t = torch.tensor(points), torch.tensor(verts[faces].reshape(-1, 9))
    whole = cuda_kernels.point_triangle_min_d2_reference(p, t, point_chunk=1 << 20, tri_chunk=1 << 20)
    tiled = cuda_kernels.point_triangle_min_d2_reference(p, t, point_chunk=7, tri_chunk=13)
    np.testing.assert_array_equal(tiled.numpy(), whole.numpy())


def test_get_distance_both_directions():
    verts, faces, _ = _soup(4, n_tri=50)
    a = Mesh(verts[:75], faces[:25])
    b = Mesh(verts[75:], faces[25:] - 75)
    inner, outer = tops.get_distance(a, b, device="cpu")
    assert inner.point_data.shape == (a.n_points,) and outer.point_data.shape == (b.n_points,)
    np.testing.assert_allclose(inner.point_data, tops.distance_to_surface(a.vertices, b, "cpu"))
    empty = Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    np.testing.assert_array_equal(tops.distance_to_surface(a.vertices, empty, "cpu"), 0.0)


def test_distance_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        cuda_kernels.point_triangle_min_d2(torch.zeros((4, 3), device="meta"), torch.zeros((2, 9), device="meta"))


@pytest.mark.parametrize("build", ["fma", "was"])
def test_launcher_refuses_cpu_tensors_and_other_types(build):
    """`point_triangle_launch` has no plain version: CPU tensors raise
    instead of taking it, and so does any type but f32."""
    p, t = torch.zeros((4, 3)), torch.zeros((2, 9))
    with pytest.raises(ValueError, match="device"):
        cuda_kernels.point_triangle_launch(p, t, build=build)
    with pytest.raises(TypeError, match="f32"):
        cuda_kernels.point_triangle_launch(p.double(), t.double(), build=build)
    with pytest.raises(TypeError, match="f32"):
        cuda_kernels.point_triangle_launch(p, t.half(), build=build)


def test_launcher_refuses_unknown_builds():
    with pytest.raises(ValueError, match="build"):
        cuda_kernels.point_triangle_launch(torch.zeros((4, 3)), torch.zeros((2, 9)), build="plain")


def test_cpu_distance_launches_no_kernel():
    verts, faces, points = _soup(5, n_tri=20, n_pts=10)
    before = cuda_kernels.point_triangle_min_d2.launches
    cuda_kernels.point_triangle_min_d2(torch.tensor(points), torch.tensor(verts[faces].reshape(-1, 9)))
    assert cuda_kernels.point_triangle_min_d2.launches == before
