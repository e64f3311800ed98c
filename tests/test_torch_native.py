"""The port's host-geometry library (`oai_analysis_2_tpu_torch/native/`)
against the JAX package's (`oai_analysis_2_tpu/native/`) and against the
port's plain numpy and scipy versions, on the CPU.

Meshes: seeded random ones (a triangulated grid with holes, its vertices
shuffled, so that it has boundaries and several components) and the
marching-cubes shell of `tests/test_torch_mesh.py` (the bench fixture's
femoral shell at 48x96x96). Both libraries build from their own copy of
`native.cpp`, so their outputs are held equal array for array; the plain
versions are held to the same adjacency, table and partition.
"""

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu import native as jnative
from oai_analysis_2_tpu.mesh import ops as jops
from oai_analysis_2_tpu_torch import native
from oai_analysis_2_tpu_torch.mesh import components as tcomponents
from oai_analysis_2_tpu_torch.mesh import ops as tops
from oai_analysis_2_tpu_torch.mesh.marching_cubes import marching_cubes
from oai_analysis_2_tpu_torch.mesh.types import Mesh

torch.set_num_threads(2)

SHAPE = (48, 96, 96)
SPACING = (0.36, 0.36, 0.7)


def _shell(r_inner, r_outer, center):
    """bench.py's `_shell_probmap`, as tests/test_torch_mesh.py builds it."""
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float32) for n in SHAPE), indexing="ij")
    rr = np.sqrt(((z - center[0]) * 2.4) ** 2 + (y - center[1]) ** 2 + (x - center[2]) ** 2)
    shell = np.clip(1.0 - np.abs(rr - (r_inner + r_outer) / 2) / ((r_outer - r_inner) / 2), 0, 1)
    return (shell * (y < center[1])).astype(np.float32)


def _grid_mesh(seed, n=24, holes=0.15):
    """An n x n grid of points, two triangles a cell, cut in two across the
    middle, a `holes` share of the other triangles dropped, the vertex
    indices shuffled."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n * n).reshape(n, n)
    a, b, c, d = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel(), idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, d], 1), np.stack([a, d, c], 1)])
    faces = faces[(rng.uniform(size=len(faces)) >= holes) & (faces[:, 0] // n != n // 2)]
    perm = rng.permutation(n * n)
    verts = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1).reshape(-1, 2)
    verts = np.concatenate([verts, rng.normal(0, 0.1, (n * n, 1))], axis=1).astype(np.float32)
    out_verts = np.empty_like(verts)
    out_verts[perm] = verts
    return Mesh(out_verts, perm[faces].astype(np.int32))


@pytest.fixture(scope="module")
def shell_mesh():
    fc = torch.tensor(_shell(27.0, 31.0, (24, 53, 48))).permute(2, 1, 0).contiguous()
    mesh = marching_cubes(fc, 0.5, SPACING)
    assert mesh.n_points > 5000
    return mesh


MESHES = ["grid0", "grid1", "grid_sparse", "shell"]


@pytest.fixture
def mesh(request, shell_mesh):
    name = request.param
    if name == "shell":
        return shell_mesh
    return {"grid0": lambda: _grid_mesh(0), "grid1": lambda: _grid_mesh(1, n=40, holes=0.05),
            "grid_sparse": lambda: _grid_mesh(2, n=16, holes=0.5)}[name]()


def _csr_rows(deg, nbr):
    offsets = np.concatenate([[0], np.cumsum(deg)])
    return [nbr[offsets[i]:offsets[i + 1]] for i in range(len(deg))]


@pytest.mark.parametrize("mesh", MESHES, indirect=True)
def test_smooth_adjacency_matches_jax(mesh):
    got = native.smooth_adjacency(mesh.n_points, mesh.faces)
    want = jnative.smooth_adjacency(mesh.n_points, mesh.faces)
    assert want is not None, "the JAX package's native library did not load"
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mesh", MESHES, indirect=True)
def test_mesh_edges_matches_jax(mesh):
    got = native.mesh_edges(mesh.faces)
    want = jnative.mesh_edges(mesh.faces)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mesh", MESHES, indirect=True)
def test_component_labels_match_jax(mesh):
    np.testing.assert_array_equal(native.connected_components(mesh.n_points, mesh.faces),
                                  jnative.connected_components(mesh.n_points, mesh.faces))


@pytest.mark.parametrize("mesh", MESHES, indirect=True)
@pytest.mark.parametrize("with_slots", [False, True])
def test_fill_table_matches_jax(mesh, with_slots):
    deg, nbr = native.smooth_adjacency(mesh.n_points, mesh.faces)
    nv = mesh.n_points + 3
    k = tops._table_width(deg.max())
    slots = np.random.default_rng(3).permutation(nv - 1)[: mesh.n_points].astype(np.int64) if with_slots else None
    got = np.full((nv, k), nv - 1, np.int32)
    want = got.copy()
    assert native.fill_table(deg, nbr, got, slots)
    assert jnative.fill_table(deg, nbr, want, slots)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", MESHES, indirect=True)
def test_union_find_partition_matches_scipy(mesh):
    """The same partition of the points as scipy's plain version: the label
    pairs (union-find, scipy) form a one-to-one map."""
    uf = tcomponents.connected_component_labels(mesh)
    sp = tcomponents.scipy_component_labels(mesh.n_points, mesh.faces)
    pairs = np.unique(np.stack([uf, sp], 1), axis=0)
    assert len(pairs) == len(np.unique(uf)) == len(np.unique(sp))
    assert len(np.unique(uf)) > 1


@pytest.mark.parametrize("mesh", MESHES, indirect=True)
def test_csr_matches_plain_adjacency(mesh):
    """Equal degrees and neighbour sets per vertex; each CSR row ascending
    (the JAX package's neighbour order)."""
    deg, nbr = tops._csr_adjacency(mesh)
    src, dst, pdeg = tops._adjacency(mesh)
    np.testing.assert_array_equal(deg, pdeg.astype(np.int64))
    order = np.lexsort((dst, src))
    np.testing.assert_array_equal(nbr, dst[order])
    for row in _csr_rows(deg, nbr)[:500]:
        assert np.all(np.diff(row) > 0)


@pytest.mark.parametrize("mesh", MESHES, indirect=True)
def test_table_from_csr_matches_plain_table(mesh):
    """The native table equals the plain `_neighbor_table` built from the
    plain edge list in the CSR's order."""
    src, dst, _ = tops._adjacency(mesh)
    order = np.lexsort((dst, src))
    nv = mesh.n_points + 1
    want = tops._neighbor_table(src[order], dst[order], nv, nv - 1)
    deg, nbr = tops._csr_adjacency(mesh)
    got = tops._table_from_csr(deg, nbr, nv, tops._table_width(deg.max()), nv - 1)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", MESHES, indirect=True)
def test_adjacency_matches_jax(mesh):
    """The port's 1-D-key `_adjacency` is bit-equal to the JAX package's."""
    for g, w in zip(tops._adjacency(mesh), jops._adjacency(mesh)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _adjacency_2d_unique(mesh):
    """The port's `_adjacency` before the 1-D key: a 2-D `np.unique` of
    sorted edge rows."""
    f = mesh.faces.astype(np.int64)
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    uniq, counts = np.unique(np.sort(edges, axis=1), axis=0, return_counts=True)
    boundary_edges = uniq[counts == 1]
    is_boundary = np.zeros(mesh.n_points, bool)
    is_boundary[np.unique(boundary_edges)] = True
    src = np.concatenate([uniq[:, 0], uniq[:, 1]])
    dst = np.concatenate([uniq[:, 1], uniq[:, 0]])
    b_src = np.concatenate([boundary_edges[:, 0], boundary_edges[:, 1]])
    b_dst = np.concatenate([boundary_edges[:, 1], boundary_edges[:, 0]])
    interior = ~is_boundary[src]
    src = np.concatenate([src[interior], b_src])
    dst = np.concatenate([dst[interior], b_dst])
    return src.astype(np.int32), dst.astype(np.int32)


@pytest.mark.parametrize("mesh", MESHES, indirect=True)
def test_adjacency_1d_key_matches_2d_unique(mesh):
    src, dst, _ = tops._adjacency(mesh)
    want_src, want_dst = _adjacency_2d_unique(mesh)
    np.testing.assert_array_equal(src, want_src)
    np.testing.assert_array_equal(dst, want_dst)


@pytest.mark.parametrize("mesh", MESHES, indirect=True)
def test_smoothing_goes_through_native(mesh):
    """`smooth_mesh` builds its table through the library (one adjacency and
    one fill a call) and equals the loop over the plain table in CSR order,
    bit for bit."""
    native.reset_calls()
    got = tops.smooth_mesh(mesh, 20, device="cpu")
    assert native.read_calls() == {"connected_components": 0, "smooth_adjacency": 1, "fill_table": 1,
                                   "mesh_edges": 0}
    src, dst, _ = tops._adjacency(mesh)
    order = np.lexsort((dst, src))
    nv = mesh.n_points + 1
    tbl = tops._neighbor_table(src[order], dst[order], nv, nv - 1)
    vp = np.zeros((nv, 3), np.float32)
    vp[: mesh.n_points] = mesh.vertices
    want = tops._smooth_loop(torch.tensor(vp), torch.tensor(tbl), 20, 0.01)[: mesh.n_points].numpy()
    np.testing.assert_array_equal(got.vertices, want)


@pytest.mark.parametrize("mesh", MESHES, indirect=True)
def test_component_filter_goes_through_native(mesh):
    """`filter_small_components` labels through the library (one call) and
    keeps exactly the faces that the scipy labels keep."""
    threshold = 3000 if mesh.n_cells > 10_000 else 100
    native.reset_calls()
    kept = tcomponents.filter_small_components(mesh, threshold)
    assert native.read_calls()["connected_components"] == 1
    face_labels = tcomponents.scipy_component_labels(mesh.n_points, mesh.faces)[mesh.faces[:, 0]]
    keep = np.isin(face_labels, np.nonzero(np.bincount(face_labels) > threshold)[0])
    want = tcomponents.extract_faces(mesh, np.nonzero(keep)[0])
    assert 0 < want.n_cells
    np.testing.assert_array_equal(kept.faces, want.faces)
    np.testing.assert_array_equal(kept.vertices, want.vertices)


@pytest.mark.parametrize("bad", [-1, 3])
def test_out_of_range_faces_raise(bad):
    """Indices the C code would use outside its per-point arrays are refused
    before any call."""
    faces = np.array([[0, 1, 2], [1, 2, bad]], np.int32)
    for fn in (native.connected_components, native.smooth_adjacency):
        with pytest.raises(ValueError, match="outside"):
            fn(3, faces)


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """A fresh build directory and no loaded library: the next call builds."""
    monkeypatch.setattr(native, "_BUILD", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path


def test_missing_compiler_raises(no_library, monkeypatch):
    empty = no_library / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    with pytest.raises(RuntimeError, match=r"g\+\+"):
        native.connected_components(3, np.array([[0, 1, 2]], np.int32))
    assert not (no_library / "native").exists()


def test_failed_build_raises(no_library, monkeypatch):
    broken = no_library / "native.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", broken)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        native.smooth_adjacency(3, np.array([[0, 1, 2]], np.int32))
    assert not list((no_library / "native").glob("*.so"))


def test_build_goes_to_the_build_directory(no_library):
    """The library is built into the build directory under a name that
    hashes the source, the flags and the target (never into the package)."""
    path = native.build()
    assert path.parent == no_library / "native" and path.name.startswith("libnative-") and path.exists()
    assert not list((no_library / "native").glob("*.tmp*"))
    assert path == native.library_path()
    assert native.connected_components(4, np.array([[0, 1, 2]], np.int32)).tolist() == [0, 0, 0, 1]
