"""RANSAC plane segmentation + PCA normal estimation (port of
autourdf_tpu.ops.plane; Open3D ``segment_plane`` / ``estimate_normals``
replacements).

Plain PyTorch on the tensors' device: neither function reaches a
hand-written kernel, as neither reached a Pallas kernel in the JAX package.
RANSAC hypotheses are scored in one batched pass; the draw of the point
triples is split from the scoring so a caller can supply its own triples.
"""

from __future__ import annotations

import torch


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


def estimate_normals(points: torch.Tensor, k: int = 30, chunk: int = 1024) -> torch.Tensor:
    """Per-point unit normals ``(N, 3)`` from PCA over the k nearest
    neighbours: a dense top-k over ``chunk`` query rows at a time, the
    smallest-eigenvalue eigenvector of each 3x3 neighbourhood covariance,
    flipped towards the +z hemisphere."""
    idx = []
    for a in range(0, points.shape[0], chunk):
        d = torch.sum((points[a:a + chunk, None, :] - points[None, :, :]) ** 2, dim=-1)
        idx.append(torch.topk(d, k, dim=1, largest=False).indices)
    neigh = points[torch.cat(idx)]                                  # (N, k, 3)
    centered = neigh - torch.mean(neigh, dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", centered, centered)
    # torch.linalg.eigh waits on the host on CUDA (PyTorch reads the solver's
    # error codes back), so the normals and the --normal resample stay
    # outside the captured programs
    _, vecs = torch.linalg.eigh(cov)
    normals = vecs[..., 0]
    return torch.where(normals[:, 2:3] < 0, -normals, normals)
