"""End-to-end single-knee demo, the reference's FullDemo.ipynb as a module
(port of `examples/full_demo.py`).

Pipeline: read a DESS volume, segment FC / TC with the 3D UNet, register
to the knee atlas with GradICON, warp the probability maps onto the atlas
grid, build thickness meshes, map them onto the atlas meshes and project
to 2D.

Usage (on the card):
    python -m oai_analysis_2_tpu_torch.examples.full_demo <image_preprocessed.nii.gz> [output_dir]
    python -m oai_analysis_2_tpu_torch.examples.full_demo phantom [output_dir]

A NIfTI input needs the release tree (models and atlas, read from
`OAI_TPU_DATA_DIR`, `utils/data.py`). `phantom` runs the same pipeline on
a synthetic two-shell knee with `AnalysisObject.offline` (synthetic atlas,
threshold-weights production segmenter): no download.
`OAI_DEMO_SHAPE=D,H,W` sets the phantom's grid (160,384,384 by default).
Writes `FC/TC_probmap_atlas.nii.gz`, `registration_checkerboard.nii.gz`,
`FC/TC_inner_thickness.vtk`, `thickness_2d.npz` and, when matplotlib
imports, the scatter PNGs `thickness_FC/TC.png` into `output_dir`
(`demo_output` by default).
"""

import os
import sys
from pathlib import Path

import numpy as np
import torch

from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject
from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.core.image import image_from_array
from oai_analysis_2_tpu_torch.core.nifti import read_nifti, write_nifti
from oai_analysis_2_tpu_torch.mesh.ops import map_attributes
from oai_analysis_2_tpu_torch.mesh.processing import get_mesh, get_thickness_mesh, split_mesh
from oai_analysis_2_tpu_torch.mesh.projection import project_thickness, rasterize_thickness
from oai_analysis_2_tpu_torch.ops.intensity import checkerboard, percentile_window
from oai_analysis_2_tpu_torch.ops.resample import resample_image
from oai_analysis_2_tpu_torch.utils.profiling import StageTimer

OUTPUT_FILES = ("FC_probmap_atlas.nii.gz", "TC_probmap_atlas.nii.gz", "registration_checkerboard.nii.gz",
                "FC_inner_thickness.vtk", "TC_inner_thickness.vtk", "thickness_2d.npz")


def main(argv=None, device=None) -> dict:
    """Run as the module's docstring says; returns the printed numbers
    (mesh sizes and mean thickness, raster coverage and mean mapped
    thickness per tissue), the stage report and the output directory."""
    argv = sys.argv[1:] if argv is None else list(argv)
    image_path = argv[0]
    out_dir = Path(argv[1] if len(argv) > 1 else "demo_output")
    dev = resolve_device(device)
    out_dir.mkdir(parents=True, exist_ok=True)

    timer = StageTimer(dev)
    if image_path == "phantom":
        obj, image = _phantom_setup(dev)
    else:
        obj = AnalysisObject(device=dev)
        image = read_nifti(image_path, device=dev)

    with timer.stage("segment"):
        fc_prob, tc_prob = obj.segment(image)
    with timer.stage("register"):
        phi = obj.register(image)
    with timer.stage("warp"):
        fc_w = resample_image(fc_prob, obj.atlas_image, displacement=phi)
        tc_w = resample_image(tc_prob, obj.atlas_image, displacement=phi)
        warped_img = resample_image(percentile_window(image), obj.atlas_image, displacement=phi)
        board = checkerboard(warped_img, obj.atlas_image.astype(torch.float32))
    with timer.stage("thickness"):
        fc_inner, fc_outer = get_thickness_mesh(fc_w, mesh_type="FC")
        tc_inner, tc_outer = get_thickness_mesh(tc_w, mesh_type="TC")
    with timer.stage("atlas_map"):
        # FullDemo cells 9-10: the atlas FC / TC inner meshes, then the
        # closest-point transfer of this knee's thickness onto them
        fc_inner_atlas, tc_inner_atlas = _atlas_inner_meshes(obj)
        mapped_fc = map_attributes(fc_inner, fc_inner_atlas, device=dev)
        mapped_tc = map_attributes(tc_inner, tc_inner_atlas, device=dev)
    with timer.stage("project"):
        # cells 11-12: unroll to 2D (FC cylindrical, TC planar) and the
        # common raster
        fc_x, fc_y, fc_t = project_thickness(mapped_fc, mesh_type="FC")
        tc_x, tc_y, tc_t = project_thickness(mapped_tc, mesh_type="TC")
        fc_map, fc_counts, fc_bounds = rasterize_thickness(fc_x, fc_y, fc_t)
        tc_map, tc_counts, tc_bounds = rasterize_thickness(tc_x, tc_y, tc_t)

    write_nifti(fc_w, out_dir / "FC_probmap_atlas.nii.gz")
    write_nifti(tc_w, out_dir / "TC_probmap_atlas.nii.gz")
    write_nifti(board, out_dir / "registration_checkerboard.nii.gz")
    fc_inner.save_vtk(out_dir / "FC_inner_thickness.vtk")
    tc_inner.save_vtk(out_dir / "TC_inner_thickness.vtk")
    np.savez(
        out_dir / "thickness_2d.npz",
        fc_x=fc_x, fc_y=fc_y, fc_thickness=fc_t,
        tc_x=tc_x, tc_y=tc_y, tc_thickness=tc_t,
        fc_map=fc_map, fc_counts=fc_counts, fc_bounds=np.asarray(fc_bounds),
        tc_map=tc_map, tc_counts=tc_counts, tc_bounds=np.asarray(tc_bounds),
    )
    _save_scatter_png(out_dir / "thickness_FC.png", fc_x, fc_y, fc_t, "FC")
    _save_scatter_png(out_dir / "thickness_TC.png", tc_x, tc_y, tc_t, "TC")
    out = {"out_dir": str(out_dir)}
    for name, mesh in (("fc", fc_inner), ("tc", tc_inner)):
        out[f"{name}_points"] = mesh.n_points
        out[f"{name}_mean_thickness"] = float(np.mean(mesh.point_data))
        out[f"{name}_median_thickness"] = float(np.median(mesh.point_data))
        print(f"{name.upper()} mesh: {mesh.n_points} pts, mean thickness {out[f'{name}_mean_thickness']:.3f}")
    for name, m, c in (("FC", fc_map, fc_counts), ("TC", tc_map, tc_counts)):
        cov = float((c > 0).mean())
        mean = float(m[c > 0].mean())
        out[f"{name.lower()}_coverage"] = cov
        out[f"{name.lower()}_mapped_mean_mm"] = mean
        print(f"{name} 2D atlas raster: coverage {cov:.1%}, mean thickness {mean:.3f} mm")
    timer.print_report()
    out["stages"] = timer.report()
    return out


def _phantom_setup(device):
    """The zero-download inputs: the offline facade (synthetic atlas,
    threshold-weights segmenter) and `_phantom_knee`, windowed to [0, 1].
    `OAI_DEMO_SHAPE=D,H,W` sets the grid."""
    shape = tuple(int(v) for v in os.environ.get("OAI_DEMO_SHAPE", "160,384,384").split(","))
    obj = AnalysisObject.offline(atlas_shape="phantom:{},{},{}".format(*shape), device=device)
    # the pipeline takes a preprocessed image, as FullDemo feeds
    # image_preprocessed.nii.gz
    return obj, percentile_window(image_from_array(_phantom_knee(shape), spacing=(0.36, 0.36, 0.7), device=device))


def _phantom_knee(shape) -> np.ndarray:
    """A two-shell knee phantom from `default_rng(7)` whose cartilage-like
    caps the threshold segmenter maps, before its window."""
    d, h, w = shape
    s = h / 384.0  # radii calibrated at the reference atlas grid
    z, y, x = np.meshgrid(*[np.arange(n, dtype=np.float32) for n in shape], indexing="ij")

    def shell(r_in, r_out, center):
        rr = np.sqrt(((z - center[0]) * 2.4) ** 2 + (y - center[1]) ** 2 + (x - center[2]) ** 2)
        mid, half = (r_in + r_out) / 2.0, (r_out - r_in) / 2.0
        cap = (y < center[1]).astype(np.float32)
        return np.clip(1.0 - np.abs(rr - mid) / half, 0.0, 1.0) * cap

    rng = np.random.default_rng(7)
    anatomy = np.maximum(
        shell(47.5 * s, 52.5 * s, (d * 0.5, h * 0.55, w * 0.5)),
        shell(31.5 * s, 35.5 * s, (d * 0.5, h * 0.6, w * 0.5)),
    )
    return (anatomy * 900.0 + rng.uniform(0.0, 250.0, shape)).astype(np.float32)


def _atlas_inner_meshes(obj):
    """The atlas FC / TC inner meshes (FullDemo cell 9), from the release's
    atlas probability maps beside the atlas image when present, else from
    segmenting the atlas image with the same segmenter."""
    fc_p = tc_p = None
    if obj.atlas_dir is not None:
        fc_file, tc_file = obj.atlas_dir / "atlas_fc.nii.gz", obj.atlas_dir / "atlas_tc.nii.gz"
        if fc_file.exists() and tc_file.exists():
            fc_p, tc_p = read_nifti(fc_file, device=obj.device), read_nifti(tc_file, device=obj.device)
    if fc_p is None:
        fc_p, tc_p = obj.segment(obj.atlas_image)
    fc_inner_atlas, _ = split_mesh(get_mesh(fc_p), mesh_type="FC", device=fc_p.device)
    tc_inner_atlas, _ = split_mesh(get_mesh(tc_p), mesh_type="TC", device=tc_p.device)
    return fc_inner_atlas, tc_inner_atlas


def _save_scatter_png(path, x, y, t, mesh_type):
    """The reference's cell 11-12 scatter plot, if matplotlib is present."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(8, 6))
    s = ax.scatter(x, y, c=t, s=2, vmin=0, vmax=4)
    fig.colorbar(s, ax=ax, label=f"Thickness {mesh_type}")
    ax.axis("off")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


if __name__ == "__main__":
    main()
