"""The PyTorch port's atlas products against the JAX package: the 2D
projection (KPCA, circle fit, cylindrical unroll), rasterization, the
closest-point transfer, `AtlasThicknessMapper`, the cohort aggregation and
`get_mesh`. Meshes are the JAX package's marching-tetrahedra balls
(tests/test_atlas_products.py) and shell caps, with seeded thickness; all
inputs are finite."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oai_analysis_2_tpu.core.image import image_from_array as jimage
from oai_analysis_2_tpu.engine import atlas_products as JA
from oai_analysis_2_tpu.mesh import ops as JO
from oai_analysis_2_tpu.mesh import processing as JP
from oai_analysis_2_tpu.mesh import projection as JPr
from oai_analysis_2_tpu.mesh.marching import marching_tetrahedra
from oai_analysis_2_tpu.ops import decomposition as JD
from oai_analysis_2_tpu_torch.core.image import image_from_array as timage
from oai_analysis_2_tpu_torch.engine import atlas_products as TA
from oai_analysis_2_tpu_torch.mesh import ops as TO
from oai_analysis_2_tpu_torch.mesh import processing as TP
from oai_analysis_2_tpu_torch.mesh import projection as TPr
from oai_analysis_2_tpu_torch.mesh.types import Mesh
from oai_analysis_2_tpu_torch.ops import decomposition as TD

torch.set_num_threads(2)


def _ball_volume(n, r, center):
    z, y, x = np.meshgrid(*[np.arange(n, dtype=np.float32)] * 3, indexing="ij")
    rr = np.sqrt((z - center[0]) ** 2 + (y - center[1]) ** 2 + (x - center[2]) ** 2)
    return np.clip(1.0 - (rr - r), 0.0, 1.0)


def _thick_mesh(n=20, r=6.0, center=(10, 10, 10), seed=0, shift=(0.0, 0.0, 0.0)) -> Mesh:
    """A ball surface (port Mesh) with thickness in [1, 3]; `shift` moves it."""
    m = marching_tetrahedra(_ball_volume(n, r, center), 0.5)
    rng = np.random.default_rng(seed)
    return Mesh(m.vertices + np.float32(shift), m.faces,
                point_data=rng.uniform(1.0, 3.0, m.n_points).astype(np.float32))


def _shell_mesh(seed=0, n=24, r=9.0, shift=(0.0, 0.0, 0.0)) -> Mesh:
    """A femoral-like cap: the y < center half of a spherical shell, whose
    (x, y) footprint is an arc the FC circle fit can take (a full ball's
    footprint is a disk with a vertex at its centroid, where the fit's
    Jacobian divides by zero)."""
    z, y, x = np.meshgrid(*[np.arange(n, dtype=np.float32)] * 3, indexing="ij")
    c = n / 2.0
    rr = np.sqrt((z - c) ** 2 + (y - c) ** 2 + (x - c) ** 2)
    vol = np.clip(1.0 - np.abs(rr - r) / 1.5, 0.0, 1.0) * (y < c - 2)
    m = marching_tetrahedra(vol.astype(np.float32), 0.5)
    rng = np.random.default_rng(seed)
    return Mesh(m.vertices + np.float32(shift), m.faces,
                point_data=rng.uniform(1.0, 3.0, m.n_points).astype(np.float32))


def _jmesh(m: Mesh):
    from oai_analysis_2_tpu.mesh.types import Mesh as JMesh

    return JMesh(m.vertices.copy(), m.faces.copy(),
                 point_data=None if m.point_data is None else np.array(m.point_data))


def test_linear_kpca_matches():
    pts = np.random.default_rng(0).normal(0, [5.0, 2.0, 0.5], (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(TD.linear_kpca(pts), JD.linear_kpca(pts))


def test_circle_fit_matches():
    """A noisy 120-degree arc: center and radius within 1e-4 mm of the JAX
    fit (both 20 f32 Gauss-Newton steps)."""
    rng = np.random.default_rng(1)
    t = rng.uniform(0.2, 2.3, 800)
    x = (30.0 + 41.0 * np.cos(t) + rng.normal(0, 0.3, t.shape)).astype(np.float32)
    y = (-12.0 + 41.0 * np.sin(t) + rng.normal(0, 0.3, t.shape)).astype(np.float32)
    (tc, tr), (jc, jr) = TD.compute_least_square_circle(x, y), JD.compute_least_square_circle(x, y)
    np.testing.assert_allclose(tc, jc, atol=1e-4)
    assert abs(tr - jr) <= 1e-4
    assert abs(tr - 41.0) < 0.5


@pytest.mark.parametrize("mesh_type", ["FC", "TC"])
def test_project_thickness_matches(mesh_type):
    """FC: angles within 1e-5 rad (the circle centers differ by f32
    rounding), z exact; TC (a ball straddling the z = 50 plateau split):
    exact, the same numpy code."""
    mesh = _shell_mesh(seed=2) if mesh_type == "FC" else _thick_mesh(seed=2, shift=(0.0, 0.0, 42.0))
    got = TPr.project_thickness(mesh, mesh_type=mesh_type)
    want = JPr.project_thickness(_jmesh(mesh), mesh_type=mesh_type)
    if mesh_type == "TC":
        assert 0 < int((mesh.vertices[:, 2] < 50).sum()) < mesh.n_points
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-5 if mesh_type == "FC" else 0.0, rtol=0)


def test_rasterize_matches_and_drops_non_finite():
    """Counts equal exactly and means within 1e-6 on finite points; a NaN
    point is dropped by the port (the JAX version bins it arbitrarily)."""
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-3, 3, 4000), rng.uniform(0, 10, 4000)
    t = rng.uniform(1, 3, 4000).astype(np.float32)
    gm, gc, gb = TPr.rasterize_thickness(x, y, t, grid_size=(64, 48))
    wm, wc, wb = JPr.rasterize_thickness(x, y, t, grid_size=(64, 48))
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gm, wm, atol=1e-6)
    assert gb == wb
    x[7], t[9] = np.nan, np.inf
    _, counts, _ = TPr.rasterize_thickness(x, y, t, grid_size=(64, 48), bounds=wb)
    assert counts.sum() == 4000 - 2


def test_map_attributes_indices_match():
    """Nearest-vertex indices identical to the JAX search, with duplicated
    source points (an exact tie keeps the first index) and queries sitting
    exactly on duplicates; more points than one source chunk."""
    rng = np.random.default_rng(4)
    src = rng.uniform(0, 40, (9000, 3)).astype(np.float32)
    src[8000:8500] = src[:500]
    query = np.concatenate([rng.uniform(0, 40, (3000, 3)), src[100:300]]).astype(np.float32)
    source = Mesh(src, np.zeros((0, 3), np.int32), point_data=np.arange(len(src), dtype=np.float64))
    target = Mesh(query, np.zeros((0, 3), np.int32))
    got = TO.map_attributes(source, target, device="cpu").point_data
    want = JO.map_attributes(_jmesh(source), _jmesh(target)).point_data
    np.testing.assert_array_equal(got, want)
    assert np.all(got[3000:] == np.arange(100, 300))


def _mappers(fc_atlas, tc_atlas):
    return (TA.AtlasThicknessMapper(fc_atlas, tc_atlas, device="cpu"),
            JA.AtlasThicknessMapper(_jmesh(fc_atlas), _jmesh(tc_atlas)))


def test_map_knee_matches():
    """FC on a shell cap, TC on a ball straddling the plateau split. Every
    payload entry: counts and transferred thickness exactly, the
    embedding within 1e-5 (FC's circle fit), mean rasters within 1e-6."""
    fc_atlas = _shell_mesh(seed=5)
    tc_atlas = _thick_mesh(n=22, r=6.5, center=(11, 11, 11), seed=6, shift=(0.0, 0.0, 42.0))
    tmap, jmap = _mappers(fc_atlas, tc_atlas)
    knee_fc, knee_tc = _shell_mesh(seed=7, shift=(0.3, 0.2, 0.1)), _thick_mesh(seed=8, shift=(0.0, 0.0, 43.0))
    # jitter the knee off the atlas's lattice: between two lattice meshes a
    # vertex is often exactly equidistant (in real arithmetic) from two
    # others, and XLA on the CPU rounds d2 through fused multiply-adds
    # (fma(dz, dz, fma(dy, dy, dx * dx))), so such ties fall either way
    rng = np.random.default_rng(9)
    for m in (knee_fc, knee_tc):
        m.vertices = m.vertices + rng.normal(0, 0.02, m.vertices.shape).astype(np.float32)
    got = tmap.map_knee(knee_fc, knee_tc)
    want = jmap.map_knee(_jmesh(knee_fc), _jmesh(knee_tc))
    assert set(got) == set(want)
    for k in want:
        if k.endswith(("_counts", "_thickness")):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5 if k.endswith(("_x", "_y", "_bounds")) else 1e-6,
                                       rtol=0, err_msg=k)
    assert TA.thickness_map_stats(got) == JA.thickness_map_stats(want)
    assert TA.thickness_map_stats(got)["fc_raster_coverage"] > 0


def test_aggregate_matches(tmp_path):
    atlas = _thick_mesh(n=22, r=6.5, center=(11, 11, 11), seed=2)
    tmap, _ = _mappers(atlas, atlas)
    paths = []
    for seed in (10, 11, 12):
        knee = _thick_mesh(seed=seed)
        p = tmp_path / f"k{seed}_thickness_2d.npz"
        np.savez_compressed(p, **tmap.map_knee(knee, knee))
        paths.append(p)
    paths.append(tmp_path / "missing.npz")
    got = TA.aggregate_thickness_maps(paths, out_path=tmp_path / "atlas.npz")
    want = JA.aggregate_thickness_maps(paths)
    assert set(got) == set(want) and int(got["n_knees"]) == 3
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with np.load(tmp_path / "atlas.npz") as z:
        np.testing.assert_array_equal(z["fc_mean"], got["fc_mean"])
    assert TA.aggregate_thickness_maps([]) is None


def test_empty_meshes_do_not_crash():
    empty = Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    atlas = _thick_mesh(seed=4)
    out = TA.AtlasThicknessMapper(atlas, empty, device="cpu").map_knee(empty, _thick_mesh(seed=5))
    assert out["fc_thickness"].shape == (atlas.n_points,) and np.all(out["fc_thickness"] == 0)
    assert out["tc_thickness"].shape == (0,)
    assert TA.thickness_map_stats(out)["tc_raster_coverage"] == 0.0


def test_get_mesh_matches():
    """get_mesh on a ball probability map: the same vertex and face counts
    as the JAX package's marching cubes (device path), and the sorted
    smoothed vertices within 1e-4 mm."""
    vol = _ball_volume(24, 8.0, (12, 11, 12)).astype(np.float32)
    spacing = (0.5, 0.6, 0.7)
    got = TP.get_mesh(timage(vol, spacing=spacing, device="cpu"), filter_threshold=100)
    want = JP.get_mesh(jimage(jnp.asarray(vol), spacing=spacing), filter_threshold=100)
    assert got.n_points == want.n_points > 500 and got.n_cells == want.n_cells
    np.testing.assert_allclose(np.sort(got.vertices, axis=0), np.sort(want.vertices, axis=0), atol=1e-4)
    assert TP.get_mesh(timage(vol, spacing=spacing, device="cpu"), filter_threshold=10**6).n_points == 0


def test_nifti_atlas_dir_raises(tmp_path):
    for name in ("atlas_fc.nii.gz", "atlas_tc.nii.gz"):
        (tmp_path / name).write_bytes(b"")
    with pytest.raises(NotImplementedError, match="NIfTI"):
        TA.AtlasThicknessMapper.from_segmenter(None, None, atlas_dir=tmp_path)
