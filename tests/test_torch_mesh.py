"""The PyTorch port's thickness stage against the JAX package, on the CPU.

The same numpy shell probability maps (48x96x96, the bench fixture's shell
at a quarter of its size) go through both packages: marching cubes, the
component filter, Laplacian smoothing, the inner/outer split and the
point-to-surface distance, stage by stage on the same input meshes, and
then `get_thickness_meshes` end to end.

Smoothing rounds differently in the two packages (XLA fuses the update into
fused multiply-adds), so smoothed vertices agree to ~6e-6 mm rather than
bit for bit. The femoral split cuts the mesh into x-bands at face
centroids; a centroid that lands within that much of a band edge changes
band, and with it a face's side. The end-to-end maps below have no such
face; the split itself is compared on identical input meshes.
"""

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu.core.image import image_from_array as jimage
from oai_analysis_2_tpu.mesh import split as JS
from oai_analysis_2_tpu.mesh.components import filter_small_components as jfilter
from oai_analysis_2_tpu.mesh.marching_cubes import marching_cubes_multi as jmc
from oai_analysis_2_tpu.mesh.ops import distance_to_surface as jdistance_to_surface
from oai_analysis_2_tpu.mesh.ops import smooth_meshes as jsmooth
from oai_analysis_2_tpu.mesh.processing import _as_xyz as jxyz
from oai_analysis_2_tpu.mesh.processing import get_thickness_meshes as jthickness
from oai_analysis_2_tpu_torch.core.image import image_from_array as timage
from oai_analysis_2_tpu_torch.mesh import split as TS
from oai_analysis_2_tpu_torch.mesh.components import filter_small_components as tfilter
from oai_analysis_2_tpu_torch.mesh.marching_cubes import marching_cubes, marching_cubes_multi
from oai_analysis_2_tpu_torch.mesh.ops import distance_to_surface as tdistance_to_surface
from oai_analysis_2_tpu_torch.mesh.ops import smooth_meshes as tsmooth
from oai_analysis_2_tpu_torch.mesh.processing import _as_xyz as txyz
from oai_analysis_2_tpu_torch.mesh.processing import get_thickness_meshes as tthickness
from oai_analysis_2_tpu_torch.mesh.types import Mesh

torch.set_num_threads(2)

SHAPE = (48, 96, 96)
SPACING = (0.36, 0.36, 0.7)


def _shell(r_inner, r_outer, center):
    """bench.py's `_shell_probmap`: a shell between two radii, upper cap."""
    d, h, w = SHAPE
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float32) for n in SHAPE), indexing="ij")
    rr = np.sqrt(((z - center[0]) * 2.4) ** 2 + (y - center[1]) ** 2 + (x - center[2]) ** 2)
    shell = np.clip(1.0 - np.abs(rr - (r_inner + r_outer) / 2) / ((r_outer - r_inner) / 2), 0, 1)
    return (shell * (y < center[1])).astype(np.float32)


@pytest.fixture(scope="module")
def maps():
    return {"FC": _shell(27.0, 31.0, (24, 53, 48)), "TC": _shell(15.5, 19.5, (24, 60, 48))}


@pytest.fixture(scope="module")
def jax_stages(maps):
    """The JAX package's meshes after each stage, per tissue."""
    out = {}
    for kind, pm in maps.items():
        raw = jmc([jxyz(jimage(pm, spacing=SPACING))], 0.5, SPACING)[0]
        filtered = jfilter(raw)
        smoothed = jsmooth([filtered])[0]
        inner, outer = JS.split_meshes([smoothed], [kind])[0]
        out[kind] = dict(raw=raw, filtered=filtered, smoothed=smoothed, inner=inner, outer=outer)
    return out


def _same_mesh(got, want, atol):
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.vertices, want.vertices, atol=atol, rtol=0)


@pytest.mark.parametrize("kind", ["FC", "TC"])
def test_marching_cubes_matches(maps, jax_stages, kind):
    """Device-path order: vertices by crossing-edge rank, faces by active
    cube; coordinates to f32 rounding (no bbox slicing here)."""
    got = marching_cubes(txyz(timage(maps[kind], spacing=SPACING, device="cpu")), 0.5, SPACING)
    assert got.n_cells > 3000
    _same_mesh(got, jax_stages[kind]["raw"], atol=1e-5)


def test_marching_cubes_multi_checks_device_count(maps):
    vol = txyz(timage(maps["TC"], spacing=SPACING, device="cpu"))
    with pytest.raises(ValueError):
        marching_cubes_multi([vol, vol], 0.5, SPACING, devices=["cpu"])
    a, b = marching_cubes_multi([vol, vol], 0.5, SPACING, devices=["cpu", "cpu"])
    np.testing.assert_array_equal(a.faces, b.faces)


@pytest.mark.parametrize("kind", ["FC", "TC"])
def test_component_filter_matches(jax_stages, kind):
    raw = jax_stages[kind]["raw"]
    got = tfilter(Mesh(raw.vertices, raw.faces))
    _same_mesh(got, jax_stages[kind]["filtered"], atol=0)


def test_smoothing_matches(jax_stages):
    """Both tissues in one loop, as the pipeline smooths them."""
    filtered = [jax_stages[k]["filtered"] for k in ("FC", "TC")]
    got = tsmooth([Mesh(m.vertices, m.faces) for m in filtered], device="cpu")
    for g, kind in zip(got, ("FC", "TC")):
        _same_mesh(g, jax_stages[kind]["smoothed"], atol=1e-4)
        # smoothing moved the vertices well beyond that tolerance
        assert np.abs(g.vertices - jax_stages[kind]["filtered"].vertices).max() > 1e-2


@pytest.mark.parametrize("kind", ["FC", "TC"])
def test_split_matches(jax_stages, kind):
    sm = jax_stages[kind]["smoothed"]
    inner, outer = TS.split_meshes([Mesh(sm.vertices, sm.faces)], [kind])[0]
    _same_mesh(inner, jax_stages[kind]["inner"], atol=0)
    _same_mesh(outer, jax_stages[kind]["outer"], atol=0)


@pytest.mark.parametrize("kind", ["FC", "TC"])
def test_distance_matches(jax_stages, kind):
    """Both directions on identical meshes (every third vertex of each
    side as the query points, to keep the plain CPU version quick)."""
    ji, jo = jax_stages[kind]["inner"], jax_stages[kind]["outer"]
    for src, dst in ((ji, jo), (jo, ji)):
        pts = src.vertices[::3]
        want = jdistance_to_surface(pts, dst)
        got = tdistance_to_surface(pts, Mesh(dst.vertices, dst.faces), device="cpu")
        assert got.shape == (len(pts),) and want.max() > 0.1
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_get_thickness_meshes_match(maps):
    kinds = ["FC", "TC"]
    want = jthickness([jimage(maps[k], spacing=SPACING) for k in kinds], kinds)
    got = tthickness([timage(maps[k], spacing=SPACING, device="cpu") for k in kinds], kinds)
    for (gi, go), (wi, wo) in zip(got, want):
        for g, w in ((gi, wi), (go, wo)):
            assert g.n_points > 1000
            _same_mesh(g, w, atol=1e-4)
            np.testing.assert_allclose(g.point_data, w.point_data, atol=1e-3, rtol=0)
