from .chamfer import chamfer_correspondences, chamfer_distance, chamfer_from_indices
from .kmeans import KMeansResult, assign, kmeans, kmeans_plusplus_init, lloyd
from .knn import PAD_COORD, nn_min_bidirectional, nn_search_bidirectional

__all__ = [
    "chamfer_distance",
    "chamfer_correspondences",
    "chamfer_from_indices",
    "nn_search_bidirectional",
    "nn_min_bidirectional",
    "PAD_COORD",
    "kmeans",
    "lloyd",
    "assign",
    "kmeans_plusplus_init",
    "KMeansResult",
]
