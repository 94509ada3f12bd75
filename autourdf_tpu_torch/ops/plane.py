"""RANSAC plane segmentation + PCA normal estimation (port of
autourdf_tpu.ops.plane; Open3D ``segment_plane`` / ``estimate_normals``
replacements).

RANSAC hypotheses are scored in one batched pass; the draw of the point
triples is split from the scoring so a caller can supply its own triples.
Plain PyTorch on the tensors' device, but for the normals' PCA: on a CUDA
tensor everything after the dense top-k (the neighbours' mean, the centred
covariance, its smallest-eigenvalue eigenvector and the flip) is one launch
of ``pca_normals_kernel`` (``csrc/geom.cu``), where ``torch.linalg.eigh``
would wait on the host, so the normals can sit inside a captured program as
they sit inside the JAX package's compiled resample.
"""

from __future__ import annotations

import torch

from . import _cuda


def draw_plane_triples(n: int, num_iterations: int, generator: torch.Generator) -> torch.Tensor:
    """``(num_iterations, 3)`` int64 point indices in ``[0, n)`` drawn from
    ``generator`` (on the generator's device)."""
    return torch.randint(0, n, (num_iterations, 3), generator=generator,
                         device=generator.device)


def segment_plane_from_triples(
    points: torch.Tensor, triples: torch.Tensor, distance_threshold: float = 0.001
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best plane among the 3-point hypotheses ``triples (I, 3)``: returns
    ``(plane (4,), inlier_mask (N,))``.  All hypotheses are scored at once;
    the first best one wins."""
    p0, p1, p2 = (points[triples[:, i]] for i in range(3))
    normal = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)          # (I, 3)
    norm = torch.linalg.norm(normal, dim=1, keepdim=True)
    normal = normal / torch.clamp_min(norm, 1e-12)
    d = -torch.sum(normal * p0, dim=1)                              # (I,)

    dist = torch.abs(points @ normal.T + d[None, :]).T              # (I, N)
    counts = torch.sum(dist < distance_threshold, dim=1)
    # degenerate (collinear) samples never win
    counts = torch.where(norm[:, 0] > 1e-9, counts, -1)
    best = torch.argmax(counts)
    best_normal, best_d = normal[best], d[best]
    inliers = torch.abs(points @ best_normal + best_d) < distance_threshold
    return torch.cat([best_normal, best_d[None]]), inliers


def segment_plane(
    points: torch.Tensor,
    generator: torch.Generator,
    distance_threshold: float = 0.001,
    num_iterations: int = 1000,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dominant plane by RANSAC: ``(plane (4,), inlier_mask (N,))``."""
    triples = draw_plane_triples(points.shape[0], num_iterations, generator).to(points.device)
    return segment_plane_from_triples(points, triples, distance_threshold)


def _smallest_eigenvector_plain(cov: torch.Tensor) -> torch.Tensor:
    """The unit eigenvector of the smallest eigenvalue of each symmetric
    ``(N, 3, 3)``, ``(N, 3)`` (its sign is the solver's)."""
    return torch.linalg.eigh(cov)[1][..., 0]


def neighbour_indices(points: torch.Tensor, k: int = 30, chunk: int = 1024) -> torch.Tensor:
    """``(N, k)`` int64 indices of each point's k nearest neighbours, itself
    included: a dense top-k over ``chunk`` query rows at a time."""
    idx = []
    for a in range(0, points.shape[0], chunk):
        d = torch.sum((points[a:a + chunk, None, :] - points[None, :, :]) ** 2, dim=-1)
        idx.append(torch.topk(d, k, dim=1, largest=False).indices)
    return torch.cat(idx)


def _pca_normals_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of ``pca_normals_kernel``: the smallest-eigenvalue
    eigenvector of each neighbourhood's covariance (unnormalised), flipped
    towards the +z hemisphere."""
    neigh = points[idx]                                             # (N, k, 3)
    centered = neigh - torch.mean(neigh, dim=1, keepdim=True)
    normals = _smallest_eigenvector_plain(torch.einsum("nki,nkj->nij", centered, centered))
    return torch.where(normals[:, 2:3] < 0, -normals, normals)


def _pca_normals_cuda(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Replaces the JAX module's covariance, ``jnp.linalg.eigh`` and flip in
    ``estimate_normals`` (autourdf_tpu/ops/plane.py:79-88).  A point a
    thread, the block's indices staged into shared memory, cyclic Jacobi
    sweeps (csrc/geom.cu)."""
    if points.dtype != torch.float32 or idx.dtype != torch.int64:
        raise TypeError(f"pca_normals_kernel takes float32 points and int64 indices, got "
                        f"{points.dtype}, {idx.dtype}")
    if idx.device != points.device:
        raise ValueError(f"pca_normals_kernel: idx on {idx.device}, points on {points.device}")
    points = points.contiguous()
    idx = idx.contiguous()
    if idx.data_ptr() % 16:
        idx = idx.clone()
    out = torch.empty_like(points)
    lib = _cuda.library("geom")
    err = _cuda.launch(lib.geom_pca_normals_launch, points, points.data_ptr(), idx.data_ptr(),
                       idx.shape[0], idx.shape[1], out.data_ptr(), _cuda.stream(points))
    _cuda.check(err, "pca_normals_kernel launch")
    _cuda.launch_counts["pca_normals"] += 1
    return out


def pca_normals(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Unit normals ``(N, 3)`` of ``points (N, 3)`` from PCA over the
    neighbourhoods ``idx (N, k)``: the smallest-eigenvalue eigenvector of
    each centred covariance, flipped towards the +z hemisphere.  The kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if points.dim() != 2 or points.shape[1] != 3 or idx.dim() != 2 \
            or idx.shape[0] != points.shape[0] or points.shape[0] == 0 or idx.shape[1] == 0:
        raise ValueError(f"expected points (N >= 1, 3) and idx (N, k >= 1), got "
                         f"{tuple(points.shape)}, {tuple(idx.shape)}")
    if points.is_cuda:
        return _pca_normals_cuda(points, idx)
    if points.device.type != "cpu":
        raise ValueError(f"unsupported device {points.device}")
    return _pca_normals_plain(points, idx)


def estimate_normals(points: torch.Tensor, k: int = 30, chunk: int = 1024) -> torch.Tensor:
    """Per-point unit normals ``(N, 3)`` from PCA over the k nearest
    neighbours: the smallest-eigenvalue eigenvector of each 3x3
    neighbourhood covariance, flipped towards the +z hemisphere."""
    return pca_normals(points, neighbour_indices(points, k, chunk))
