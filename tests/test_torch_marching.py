"""Marching tetrahedra, the grouped Laplacian smoothing and the grouped
thickness of the PyTorch port against the JAX package, on the CPU.

The same seeded numpy volumes go through both packages. The iso-surface is
held to JAX's exactly in counts and faces and within 1e-5 (index units x
spacing) in vertices; the smoothed and split thickness meshes to the
whole-slice tolerances of tests/test_torch_public.py (sizes within 0.5 %,
mean thickness within 1e-3 mm). Within the port, grouped smoothing and
grouped thickness must equal the per-knee results exactly.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import jax.numpy as jnp

from oai_analysis_2_tpu.core.image import image_from_array as jimage
from oai_analysis_2_tpu.mesh import ops as JO
from oai_analysis_2_tpu.mesh import processing as JP
from oai_analysis_2_tpu.mesh.marching import marching_tetrahedra as j_tets
from oai_analysis_2_tpu_torch.core.image import image_from_array as timage
from oai_analysis_2_tpu_torch.mesh import ops as TO
from oai_analysis_2_tpu_torch.mesh import processing as TP
from oai_analysis_2_tpu_torch.mesh.marching import marching_tetrahedra as t_tets
from oai_analysis_2_tpu_torch.mesh.marching_cubes import marching_cubes
from oai_analysis_2_tpu_torch.mesh.types import Mesh

torch.set_num_threads(2)


def _ball(n=32, r=10.0):
    g = np.arange(n, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (r - np.sqrt((x - n / 2) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)).astype(np.float32)


def _edge_counts(mesh):
    e = np.concatenate([mesh.faces[:, [0, 1]], mesh.faces[:, [1, 2]], mesh.faces[:, [2, 0]]], axis=0)
    _, counts = np.unique(np.sort(e, axis=1), axis=0, return_counts=True)
    return counts


def _shell_cap(n=32, r=11.0, shift=0.0):
    z, y, x = np.meshgrid(*[np.arange(n, dtype=np.float32)] * 3, indexing="ij")
    c = n / 2.0
    rr = np.sqrt((z - c) ** 2 + (y - c - shift) ** 2 + (x - c) ** 2)
    return (np.clip(1.0 - np.abs(rr - r) / 2.0, 0.0, 1.0) * (y < c - 2)).astype(np.float32)


def _assert_same_surface(got, want):
    assert got.n_points == want.n_points and got.n_cells == want.n_cells
    np.testing.assert_allclose(got.vertices, want.vertices, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.faces, want.faces)


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (0.36, 0.36, 0.7)])
def test_sphere_matches_jax_watertight_euler(spacing):
    """A sphere: JAX's surface from its device path (jax input) and its host
    path (numpy input); every edge shared by two faces, V - E + F = 2."""
    vol = _ball()
    got = t_tets(torch.tensor(vol), 0.0, spacing)
    for src in (jnp.asarray(vol), vol):
        _assert_same_surface(got, j_tets(src, level=0.0, spacing=spacing))
    counts = _edge_counts(got)
    assert np.all(counts == 2), "watertight"
    assert got.n_points - len(counts) + got.n_cells == 2, "sphere Euler characteristic"


@pytest.mark.parametrize("seed", [0, 1])
def test_random_field_matches_jax(seed):
    """Uniform noise (every cube case, surfaces touching the border)."""
    vol = np.random.default_rng(seed).uniform(size=(11, 13, 9)).astype(np.float32)
    got = t_tets(torch.tensor(vol), 0.5, (0.5, 0.6, 0.7))
    assert got.n_cells > 1000
    _assert_same_surface(got, j_tets(jnp.asarray(vol), level=0.5, spacing=(0.5, 0.6, 0.7)))


def test_random_blobs_watertight_interior():
    """Smoothed noise whose surfaces stay inside: no holes, and the ascent
    orientation gives the same signed volume sign as marching cubes."""
    rng = np.random.default_rng(7)
    for _ in range(3):
        vol = gaussian_filter(rng.normal(size=(12, 12, 12)).astype(np.float32), 1.5)
        vol[[0, -1]], vol[:, [0, -1]], vol[:, :, [0, -1]] = -10.0, -10.0, -10.0
        mesh = t_tets(torch.tensor(vol), 0.0)
        if mesh.n_cells == 0:
            continue
        assert np.all(_edge_counts(mesh) == 2)
        _assert_same_surface(mesh, j_tets(jnp.asarray(vol), level=0.0))

    def signed_volume(m):
        tri = m.triangles()
        return np.einsum("ij,ij->i", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum() / 6.0

    ball = torch.tensor(_ball(16, 5.0))
    assert np.sign(signed_volume(t_tets(ball, 0.0))) == np.sign(signed_volume(marching_cubes(ball, 0.0))) != 0


def test_empty_inputs():
    for vol in (np.zeros((6, 6, 6), np.float32), np.ones((6, 6, 6), np.float32), np.ones((1, 6, 6), np.float32)):
        mesh = t_tets(torch.tensor(vol), 0.5)
        assert mesh.n_points == 0 and mesh.n_cells == 0
        assert mesh.vertices.shape == (0, 3) and mesh.faces.shape == (0, 3)


def test_get_mesh_tets_matches():
    """get_mesh(method="tets"): components filtered and 30 smoothing
    iterations, within 1e-5 mm of JAX's, same faces."""
    vol = _shell_cap()
    meta = dict(spacing=(0.5, 0.5, 0.7))
    got = TP.get_mesh(timage(vol, device="cpu", **meta), num_iterations=30, filter_threshold=100, method="tets")
    want = JP.get_mesh(jimage(vol, **meta), num_iterations=30, filter_threshold=100, method="tets")
    assert got.n_points > 1000
    _assert_same_surface(got, want)


def _meshes(seed, n):
    """`n` small meshes of different sizes (iso-surfaces of smoothed noise)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        vol = gaussian_filter(rng.normal(size=(10 + i, 12, 11)).astype(np.float32), 1.2)
        out.append(marching_cubes(torch.tensor(vol), 0.0, (0.5, 0.6, 0.7)))
    return out


def test_smooth_mesh_groups_equals_smooth_meshes():
    """Each group, grouped with others of other sizes and an empty group,
    bit-equal to `smooth_meshes(group)`, and within 1e-5 of JAX's
    `smooth_mesh_groups`."""
    meshes = _meshes(3, 5)
    empty = Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    groups = [meshes[:2], [], meshes[2:3], [meshes[3], empty, meshes[4]]]
    got = TO.smooth_mesh_groups(groups, num_iterations=40, device="cpu")
    assert [len(g) for g in got] == [len(g) for g in groups]
    for g_in, g_out in zip(groups, got):
        for want, m in zip(TO.smooth_meshes(g_in, num_iterations=40, device="cpu"), g_out):
            np.testing.assert_array_equal(m.vertices, want.vertices)
            np.testing.assert_array_equal(m.faces, want.faces)
    jgot = JO.smooth_mesh_groups([g for g in groups if g], num_iterations=40)
    for g_out, j_out in zip([g for g in got if g], jgot):
        for m, w in zip(g_out, j_out):
            np.testing.assert_allclose(m.vertices, w.vertices, atol=1e-5)
    assert TO.smooth_mesh_groups([[], []], device="cpu") == [[], []]


@pytest.fixture(scope="module")
def two_knees():
    """Two knees' FC + TC maps on one 32^3 grid: shells of other radii and
    centres."""
    maps = [_shell_cap(r=11.0), _shell_cap(r=7.0, shift=1.0), _shell_cap(r=11.5, shift=-1.0), _shell_cap(r=6.5)]
    meta = dict(spacing=(0.5, 0.5, 0.7))
    return [timage(m, device="cpu", **meta) for m in maps], [jimage(m, **meta) for m in maps]


def test_grouped_thickness_equals_per_knee(two_knees):
    """group_size=2 over two knees equals each knee's own call, exactly."""
    timgs, _ = two_knees
    kw = dict(num_iterations=30, filter_threshold=100)
    got = TP.get_thickness_meshes(timgs, ["FC", "TC"] * 2, group_size=2, **kw)
    want = TP.get_thickness_meshes(timgs[:2], ["FC", "TC"], **kw) + TP.get_thickness_meshes(timgs[2:], ["FC", "TC"], **kw)
    for g_pair, w_pair in zip(got, want):
        for g, w in zip(g_pair, w_pair):
            assert g.n_points > 100
            np.testing.assert_array_equal(g.vertices, w.vertices)
            np.testing.assert_array_equal(g.point_data, w.point_data)


@pytest.mark.parametrize("method", ["mc", "tets"])
def test_thickness_meshes_grouped_match_jax(two_knees, method):
    """get_thickness_meshes(method, group_size=2) in both packages: sizes
    within 0.5 %, mean thickness within 1e-3 mm."""
    timgs, jimgs = two_knees
    kw = dict(num_iterations=30, filter_threshold=100, method=method, group_size=2)
    timings = {}
    got = TP.get_thickness_meshes(timgs, ["FC", "TC"] * 2, timings_out=timings, **kw)
    want = JP.get_thickness_meshes(jimgs, ["FC", "TC"] * 2, **kw)
    assert set(timings) == {"mc", "components", "smooth", "split", "distance"}
    for g_pair, w_pair in zip(got, want):
        for g, w in zip(g_pair, w_pair):
            assert w.n_points > 100 and abs(g.n_points - w.n_points) <= 0.005 * w.n_points
            assert abs(float(np.mean(g.point_data)) - float(np.mean(w.point_data))) <= 1e-3
    assert TP.get_thickness_meshes([], []) == []
