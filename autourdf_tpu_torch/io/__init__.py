from .mesh_io import TriMesh, load_mesh, load_obj, load_stl, sample_surface, save_stl
from .ply import read_ply, write_ply

__all__ = ["read_ply", "write_ply", "TriMesh", "load_mesh", "load_obj", "load_stl",
           "save_stl", "sample_surface"]
