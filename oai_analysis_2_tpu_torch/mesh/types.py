"""Triangle-mesh container (copy of `oai_analysis_2_tpu/mesh/types.py`).

One plain struct: numpy vertices/faces plus optional per-point and
per-cell scalars. Geometry bookkeeping lives on the host; the hot kernels
(marching cubes, smoothing, distance) move the arrays to the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    """vertices: (P, 3) float32; faces: (F, 3) int32 vertex indices.
    point_data / cell_data: optional scalar arrays of length P / F."""

    vertices: np.ndarray
    faces: np.ndarray
    point_data: Optional[np.ndarray] = None
    cell_data: Optional[np.ndarray] = None

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float32).reshape(-1, 3)
        self.faces = np.asarray(self.faces, np.int32).reshape(-1, 3)

    @property
    def n_points(self) -> int:
        return len(self.vertices)

    @property
    def n_cells(self) -> int:
        return len(self.faces)

    def bounds(self):
        """(xmin, xmax, ymin, ymax, zmin, zmax) — vtk GetBounds order."""
        lo = self.vertices.min(axis=0)
        hi = self.vertices.max(axis=0)
        return (lo[0], hi[0], lo[1], hi[1], lo[2], hi[2])

    def copy(self) -> "Mesh":
        return Mesh(
            self.vertices.copy(),
            self.faces.copy(),
            None if self.point_data is None else np.array(self.point_data),
            None if self.cell_data is None else np.array(self.cell_data),
        )

    def triangles(self) -> np.ndarray:
        """(F, 3, 3) corner coordinates."""
        return self.vertices[self.faces]

    # -- I/O (replaces itk.meshwrite / vtk readers used by notebooks) -----------

    def save_vtk(self, path) -> None:
        """Legacy ASCII VTK PolyData writer (readable by ParaView/VTK)."""
        with open(path, "w") as f:
            f.write("# vtk DataFile Version 3.0\noai_analysis_2_tpu mesh\nASCII\n")
            f.write("DATASET POLYDATA\n")
            f.write(f"POINTS {self.n_points} float\n")
            for p in self.vertices:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
            f.write(f"POLYGONS {self.n_cells} {self.n_cells * 4}\n")
            for c in self.faces:
                f.write(f"3 {c[0]} {c[1]} {c[2]}\n")
            if self.point_data is not None:
                f.write(f"POINT_DATA {self.n_points}\n")
                f.write("SCALARS thickness float 1\nLOOKUP_TABLE default\n")
                for v in np.asarray(self.point_data).reshape(-1):
                    f.write(f"{v}\n")

    @staticmethod
    def load_vtk(path) -> "Mesh":
        """Minimal ASCII VTK PolyData reader (inverse of save_vtk)."""
        with open(path) as f:
            tokens = f.read().split()
        verts = faces = pdata = None
        i = 0
        while i < len(tokens):
            t = tokens[i].upper()
            if t == "POINTS":
                n = int(tokens[i + 1])
                verts = np.array(tokens[i + 3 : i + 3 + 3 * n], np.float32).reshape(n, 3)
                i += 3 + 3 * n
            elif t == "POLYGONS":
                n, total = int(tokens[i + 1]), int(tokens[i + 2])
                flat = np.array(tokens[i + 3 : i + 3 + total], np.int64).reshape(n, 4)
                faces = flat[:, 1:].astype(np.int32)
                i += 3 + total
            elif t == "SCALARS":
                # SCALARS name type [numComp] [LOOKUP_TABLE name], then the
                # values (the JAX package's reader starts one token early
                # and fails on its own files)
                j = i + 3
                if tokens[j].isdigit():
                    j += 1
                if tokens[j].upper() == "LOOKUP_TABLE":
                    j += 2
                n = len(verts)
                pdata = np.array(tokens[j : j + n], np.float32)
                i = j + n
            else:
                i += 1
        return Mesh(verts, faces, point_data=pdata)
