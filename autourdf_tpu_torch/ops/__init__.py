from .chamfer import (
    chamfer_correspondences,
    chamfer_directional,
    chamfer_distance,
    chamfer_distance_trunc,
    chamfer_from_indices,
)
from .fps import farthest_point_sample
from .icp import ICPResult, icp_point_to_point, masked_icp_clusters
from .kmeans import KMeansResult, assign, kmeans, kmeans_plusplus_init, lloyd
from .knn import PAD_COORD, nn_min_bidirectional, nn_search, nn_search_bidirectional
from .plane import estimate_normals, segment_plane

__all__ = [
    "chamfer_distance",
    "chamfer_correspondences",
    "chamfer_from_indices",
    "chamfer_distance_trunc",
    "chamfer_directional",
    "nn_search",
    "farthest_point_sample",
    "icp_point_to_point",
    "masked_icp_clusters",
    "ICPResult",
    "segment_plane",
    "estimate_normals",
    "nn_search_bidirectional",
    "nn_min_bidirectional",
    "PAD_COORD",
    "kmeans",
    "lloyd",
    "assign",
    "kmeans_plusplus_init",
    "KMeansResult",
]
