from oai_analysis_2_tpu_torch.mesh.types import Mesh
from oai_analysis_2_tpu_torch.mesh.marching import marching_tetrahedra
from oai_analysis_2_tpu_torch.mesh.ops import map_attributes
from oai_analysis_2_tpu_torch.mesh.processing import (
    get_thickness_meshes,
    get_cell_centroid,
    get_cell_normals,
    get_distance,
    get_mesh,
    get_mesh_from_probability_map,
    get_thickness_mesh,
    smooth_mesh,
    split_mesh,
)
from oai_analysis_2_tpu_torch.mesh.projection import project_thickness

__all__ = [
    "Mesh",
    "marching_tetrahedra",
    "get_cell_centroid",
    "get_cell_normals",
    "get_distance",
    "get_mesh",
    "get_mesh_from_probability_map",
    "get_thickness_mesh",
    "get_thickness_meshes",
    "map_attributes",
    "project_thickness",
    "smooth_mesh",
    "split_mesh",
]
