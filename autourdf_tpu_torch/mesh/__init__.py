from .marching import is_watertight, marching_tetrahedra
from .meshing import (
    cloud_to_mesh,
    generate_link_meshes,
    laplacian_smooth,
    remove_statistical_outliers,
    voxelize,
)

__all__ = [
    "marching_tetrahedra",
    "is_watertight",
    "cloud_to_mesh",
    "generate_link_meshes",
    "voxelize",
    "laplacian_smooth",
    "remove_statistical_outliers",
]
