"""Atlas-mapped 2D thickness rasters and their cohort aggregation (port of
`oai_analysis_2_tpu/engine/atlas_products.py:31-191`).

`AtlasThicknessMapper` computes the atlas inner meshes' 2D embedding once
(FC cylindrical unroll, TC planar KPCA: host numpy); per knee it transfers
thickness to the atlas vertices by closest point (on the mapper's device)
and bins it on a fixed grid, so every knee lands on the same raster and
`aggregate_thickness_maps` folds a cohort into population atlases.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.core.nifti import read_nifti
from oai_analysis_2_tpu_torch.mesh.ops import map_attributes
from oai_analysis_2_tpu_torch.mesh.processing import get_mesh, split_mesh
from oai_analysis_2_tpu_torch.mesh.projection import project_thickness, rasterize_thickness
from oai_analysis_2_tpu_torch.mesh.types import Mesh

_GRID = (128, 128)


class AtlasThicknessMapper:
    """Maps per-knee inner thickness meshes onto the atlas geometry and a
    fixed 2D raster grid; the nearest-vertex search runs on `device`."""

    def __init__(self, fc_atlas_inner: Mesh, tc_atlas_inner: Mesh,
                 grid_size: Tuple[int, int] = _GRID, device=None):
        self.fc_atlas_inner = fc_atlas_inner
        self.tc_atlas_inner = tc_atlas_inner
        self.grid_size = tuple(grid_size)
        self.device = resolve_device(device)
        self._emb = {}
        for name, mesh in (("FC", fc_atlas_inner), ("TC", tc_atlas_inner)):
            if mesh.n_points == 0:
                self._emb[name] = (
                    np.zeros(0, np.float32), np.zeros(0, np.float32),
                    np.zeros(0, np.int64), (0.0, 1.0, 0.0, 1.0),
                )
                continue
            # project with point_data = arange, so the returned "thickness"
            # is TC's right/left reordering as a permutation of atlas
            # vertex indices (FC's is the identity)
            probe = mesh.copy()
            probe.point_data = np.arange(mesh.n_points, dtype=np.float64)
            x, y, perm = project_thickness(probe, mesh_type=name)
            perm = perm.astype(np.int64)
            bounds = (float(x.min()), float(x.max()), float(y.min()), float(y.max()))
            # native (float64) precision: binning must not move points
            # across raster-cell edges
            self._emb[name] = (np.asarray(x), np.asarray(y), perm, bounds)

    @classmethod
    def from_segmenter(cls, segmenter, atlas_image, atlas_dir: Optional[Path] = None,
                       grid_size: Tuple[int, int] = _GRID,
                       filter_threshold: int = 3000) -> "AtlasThicknessMapper":
        """Build the atlas inner meshes on the atlas image's device from the
        release's atlas probability maps (atlas_fc/tc.nii.gz in `atlas_dir`)
        when both exist, else by segmenting the atlas image with
        `segmenter`."""
        fc_p = tc_p = None
        if atlas_dir is not None:
            fc_file, tc_file = Path(atlas_dir) / "atlas_fc.nii.gz", Path(atlas_dir) / "atlas_tc.nii.gz"
            if fc_file.exists() and tc_file.exists():
                fc_p = read_nifti(fc_file, device=atlas_image.device)
                tc_p = read_nifti(tc_file, device=atlas_image.device)
        if fc_p is None:
            fc_p, tc_p = segmenter.segment(atlas_image, if_output_prob_map=True)
        fc_inner, _ = split_mesh(get_mesh(fc_p, filter_threshold=filter_threshold), mesh_type="FC")
        tc_inner, _ = split_mesh(get_mesh(tc_p, filter_threshold=filter_threshold), mesh_type="TC")
        return cls(fc_inner, tc_inner, grid_size=grid_size, device=atlas_image.device)

    def map_knee(self, fc_inner: Mesh, tc_inner: Mesh) -> dict:
        """One knee's inner thickness meshes -> atlas-mapped scatter and
        fixed-grid raster: {fc,tc}_{x,y,thickness,map,counts,bounds}, `map`
        the per-knee mean raster and `counts` the bin occupancy."""
        out = {}
        for name, knee_mesh, atlas_mesh in (
            ("fc", fc_inner, self.fc_atlas_inner),
            ("tc", tc_inner, self.tc_atlas_inner),
        ):
            x, y, perm, bounds = self._emb[name.upper()]
            if knee_mesh.n_points == 0 or atlas_mesh.n_points == 0:
                t = np.zeros(len(perm), np.float32)
            else:
                mapped = map_attributes(knee_mesh, atlas_mesh, device=self.device)
                t = np.asarray(mapped.point_data, np.float32)[perm]
            mean, counts, _ = rasterize_thickness(x, y, t, grid_size=self.grid_size, bounds=bounds)
            out[f"{name}_x"] = np.asarray(x, np.float32)
            out[f"{name}_y"] = np.asarray(y, np.float32)
            out[f"{name}_thickness"] = t
            out[f"{name}_map"] = mean
            out[f"{name}_counts"] = counts
            out[f"{name}_bounds"] = np.asarray(bounds, np.float64)
        return out


def thickness_map_stats(maps: dict) -> dict:
    """Scalar summary of a map_knee() payload for manifests and logs."""
    stats = {}
    for name in ("fc", "tc"):
        m, c = maps[f"{name}_map"], maps[f"{name}_counts"]
        occ = c > 0
        stats[f"{name}_mean_thickness_mm"] = round(float(m[occ].mean()), 4) if occ.any() else 0.0
        stats[f"{name}_raster_coverage"] = round(float(occ.mean()), 4)
    return stats


def aggregate_thickness_maps(paths: Sequence, out_path=None) -> Optional[dict]:
    """Fold per-knee thickness_2d.npz files into population atlases: the
    binwise sum(mean * counts) / sum(counts). Unreadable files and rasters
    of another grid are skipped. Returns {fc,tc}_{mean,counts,bounds} and
    n_knees, and writes them as one npz to `out_path` if given."""
    acc = None
    n = 0
    for p in paths:
        try:
            with np.load(p) as z:
                knee = {k: z[k] for k in z.files}
        except (OSError, ValueError):
            continue
        if acc is None:
            acc = {
                "fc_sum": np.zeros_like(knee["fc_map"], np.float64),
                "fc_counts": np.zeros_like(knee["fc_counts"], np.int64),
                "tc_sum": np.zeros_like(knee["tc_map"], np.float64),
                "tc_counts": np.zeros_like(knee["tc_counts"], np.int64),
                "fc_bounds": knee["fc_bounds"],
                "tc_bounds": knee["tc_bounds"],
            }
        for name in ("fc", "tc"):
            if knee[f"{name}_map"].shape != acc[f"{name}_sum"].shape:
                continue
            acc[f"{name}_sum"] += knee[f"{name}_map"].astype(np.float64) * knee[f"{name}_counts"]
            acc[f"{name}_counts"] += knee[f"{name}_counts"]
        n += 1
    if acc is None:
        return None
    out = {"n_knees": np.int64(n)}
    for name in ("fc", "tc"):
        c = acc[f"{name}_counts"]
        out[f"{name}_mean"] = np.divide(
            acc[f"{name}_sum"], c, out=np.zeros_like(acc[f"{name}_sum"]), where=c > 0
        ).astype(np.float32)
        out[f"{name}_counts"] = c
        out[f"{name}_bounds"] = acc[f"{name}_bounds"]
    if out_path is not None:
        np.savez_compressed(out_path, **out)
    return out
