"""Thickness-only demo, the reference's ComputeThicknessDemo.ipynb as a
module (port of `examples/thickness_demo.py`): a probability map in, the
inner and outer thickness meshes and the 2D projection out.

Usage (on the card):
    python -m oai_analysis_2_tpu_torch.examples.thickness_demo <probmap.nii.gz> <FC|TC> [out_dir]

Writes `<type>_inner_thickness.vtk`, `<type>_outer_thickness.vtk` and
`<type>_thickness_2d.npz` (keys x, y, thickness) into `out_dir`
(`thickness_output` by default). Needs no release tree.
"""

import sys
from pathlib import Path

import numpy as np

from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.core.nifti import read_nifti
from oai_analysis_2_tpu_torch.mesh.processing import get_thickness_mesh
from oai_analysis_2_tpu_torch.mesh.projection import project_thickness


def main(argv=None, device=None) -> dict:
    """Run as the module's docstring says; returns the printed numbers."""
    argv = sys.argv[1:] if argv is None else list(argv)
    prob_path = argv[0]
    mesh_type = argv[1] if len(argv) > 1 else "FC"
    out_dir = Path(argv[2] if len(argv) > 2 else "thickness_output")
    dev = resolve_device(device)
    out_dir.mkdir(parents=True, exist_ok=True)

    prob = read_nifti(prob_path, device=dev)
    inner, outer = get_thickness_mesh(prob, mesh_type=mesh_type)
    mean, top = float(np.mean(inner.point_data)), float(np.max(inner.point_data))
    print(f"inner: {inner.n_points} pts, thickness mean {mean:.3f} max {top:.3f}")
    print(f"outer: {outer.n_points} pts")
    inner.save_vtk(out_dir / f"{mesh_type}_inner_thickness.vtk")
    outer.save_vtk(out_dir / f"{mesh_type}_outer_thickness.vtk")

    x2d, y2d, th = project_thickness(inner, mesh_type=mesh_type)
    np.savez(out_dir / f"{mesh_type}_thickness_2d.npz", x=x2d, y=y2d, thickness=th)
    print("wrote", out_dir)
    return {"inner_points": inner.n_points, "inner_mean_thickness": mean, "inner_max_thickness": top,
            "outer_points": outer.n_points, "out_dir": str(out_dir)}


if __name__ == "__main__":
    main()
