"""RANSAC plane segmentation + PCA normal estimation (port of
autourdf_tpu.ops.plane; Open3D ``segment_plane`` / ``estimate_normals``
replacements).

RANSAC hypotheses are scored in one batched pass; the draw of the point
triples is split from the scoring so a caller can supply its own triples.
Plain PyTorch on the tensors' device, but for the normals' eigenvectors: on
a CUDA tensor the smallest-eigenvalue eigenvector of every neighbourhood
covariance comes from one launch of ``sym_eig3_min_kernel``
(``csrc/geom.cu``), where ``torch.linalg.eigh`` would wait on the host, so
the normals can sit inside a captured program as they sit inside the JAX
package's compiled resample.
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
    """Plain version of ``sym_eig3_min_kernel``: the unit eigenvector of the
    smallest eigenvalue of each symmetric ``(N, 3, 3)``, ``(N, 3)``."""
    return torch.linalg.eigh(cov)[1][..., 0]


def _smallest_eigenvector_cuda(cov: torch.Tensor) -> torch.Tensor:
    """Replaces ``jnp.linalg.eigh`` in the JAX module's ``estimate_normals``
    (autourdf_tpu/ops/plane.py:56).  One thread a matrix, fixed sweeps of
    cyclic Jacobi rotations (csrc/geom.cu)."""
    if cov.dtype != torch.float32:
        raise TypeError(f"sym_eig3_min_kernel takes float32, got {cov.dtype}")
    cov = cov.contiguous()
    out = torch.empty(cov.shape[:2], dtype=cov.dtype, device=cov.device)
    lib = _cuda.library("geom")
    err = _cuda.launch(lib.geom_sym_eig3_min_launch, cov, cov.data_ptr(), out.data_ptr(),
                       cov.shape[0], _cuda.stream(cov))
    _cuda.check(err, "sym_eig3_min_kernel launch")
    _cuda.launch_counts["sym_eig3_min"] += 1
    return out


def smallest_eigenvector(cov: torch.Tensor) -> torch.Tensor:
    """The unit eigenvector of the smallest eigenvalue of each symmetric
    ``cov (N, 3, 3)`` (its sign is the solver's): the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if cov.dim() != 3 or cov.shape[1:] != (3, 3) or cov.shape[0] == 0:
        raise ValueError(f"expected cov (N >= 1, 3, 3), got {tuple(cov.shape)}")
    if cov.is_cuda:
        return _smallest_eigenvector_cuda(cov)
    if cov.device.type != "cpu":
        raise ValueError(f"unsupported device {cov.device}")
    return _smallest_eigenvector_plain(cov)


def neighbourhood_covariances(points: torch.Tensor, k: int = 30,
                              chunk: int = 1024) -> torch.Tensor:
    """``(N, 3, 3)`` covariances (unnormalised) of each point's k nearest
    neighbours, itself included: a dense top-k over ``chunk`` query rows at
    a time."""
    idx = []
    for a in range(0, points.shape[0], chunk):
        d = torch.sum((points[a:a + chunk, None, :] - points[None, :, :]) ** 2, dim=-1)
        idx.append(torch.topk(d, k, dim=1, largest=False).indices)
    neigh = points[torch.cat(idx)]                                  # (N, k, 3)
    centered = neigh - torch.mean(neigh, dim=1, keepdim=True)
    return torch.einsum("nki,nkj->nij", centered, centered)


def estimate_normals(points: torch.Tensor, k: int = 30, chunk: int = 1024) -> torch.Tensor:
    """Per-point unit normals ``(N, 3)`` from PCA over the k nearest
    neighbours: the smallest-eigenvalue eigenvector of each 3x3
    neighbourhood covariance, flipped towards the +z hemisphere."""
    normals = smallest_eigenvector(neighbourhood_covariances(points, k, chunk))
    return torch.where(normals[:, 2:3] < 0, -normals, normals)
