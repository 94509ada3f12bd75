"""k-means (Lloyd's + k-means++ seeding) for cluster (re)sampling.

Port of autourdf_tpu.ops.kmeans.  Points ``(N, D)`` with centers
``(K, D)``, or a batch ``(B, N, D)`` with ``(B, K, D)`` (the registration
driver resamples every sequence at once); optional point mask for padded
inputs.  Assignment distances use the ``|x|^2 - 2 x.c + |c|^2`` expansion
and the update step is a one-hot product, as in the JAX module.  The
iteration count is fixed and convergence freezes each batch element on the
device, so the loop never waits on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .fps import farthest_point_sample
from .reduce import row_sums


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # (..., K, D)
    labels: torch.Tensor   # (..., N) int64
    inertia: torch.Tensor  # (...) sum of squared distances


def _sq_dists(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(..., N, D), (..., K, D) -> (..., N, K) squared euclidean distances."""
    xn = torch.sum(points * points, dim=-1, keepdim=True)
    cn = torch.sum(centers * centers, dim=-1)
    cross = points @ centers.transpose(-1, -2)
    return torch.clamp_min(xn - 2.0 * cross + cn[..., None, :], 0.0)


def assign(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return torch.argmin(_sq_dists(points, centers), dim=-1)


def lloyd(
    points: torch.Tensor,
    init_centers: torch.Tensor,
    iters: int = 64,
    mask: torch.Tensor | None = None,
    tol: float = 1e-4,
) -> KMeansResult:
    """Lloyd's algorithm with fixed iteration count and convergence freeze.

    Matches sklearn's warm-start behaviour (n_init=1): iterate assignment /
    mean update until the squared center shift divided by the data variance
    drops below ``tol`` (sklearn's relative tol), then hold.  Empty clusters
    keep their previous center.
    """
    if points.dim() == 2:
        res = lloyd(points[None], init_centers[None], iters,
                    None if mask is None else mask[None], tol)
        return KMeansResult(res.centers[0], res.labels[0], res.inertia[0])
    k = init_centers.shape[-2]
    m = None if mask is None else mask.to(points.dtype)
    # the data variance, each sequence's sums independent of the batch it is
    # in (ops/reduce.py): the freeze threshold must not change with it
    pts = points.transpose(-1, -2)                                    # (S, D, N)
    w = torch.ones_like(pts[..., :1, :]) if m is None else m[..., None, :]
    sums = row_sums(torch.cat([w, w * pts], dim=-2))               # (S, 1 + D)
    cnt = sums[..., 0]
    mean = sums[..., 1:] / torch.clamp_min(cnt, 1.0)[..., None]
    var = (row_sums((w * (pts - mean[..., None]) ** 2).flatten(-2))
           / torch.clamp_min(cnt * points.shape[-1], 1.0))
    shift_tol = tol * var
    cluster_ids = torch.arange(k, device=points.device)

    centers = init_centers
    done = torch.zeros(points.shape[0], dtype=torch.bool, device=points.device)
    for _ in range(iters):
        labels = torch.argmin(_sq_dists(points, centers), dim=-1)
        onehot = (labels[..., None] == cluster_ids).to(points.dtype)
        if m is not None:
            onehot = onehot * m[..., None]
        counts = torch.sum(onehot, dim=-2)
        sums = onehot.transpose(-1, -2) @ points
        new_centers = torch.where(
            counts[..., None] > 0, sums / torch.clamp_min(counts[..., None], 1.0), centers
        )
        shift = torch.sum((new_centers - centers) ** 2, dim=(-2, -1))
        new_done = done | (shift <= shift_tol)
        centers = torch.where(done[:, None, None], centers, new_centers)
        done = new_done
    d = _sq_dists(points, centers)
    labels = torch.argmin(d, dim=-1)
    best = torch.amin(d, dim=-1)
    if m is not None:
        best = best * m
    return KMeansResult(centers, labels, torch.sum(best, dim=-1))


def kmeans_plusplus_init(
    generator: torch.Generator,
    points: torch.Tensor,
    k: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """D^2-weighted k-means++ seeding of one cloud ``(N, D) -> (K, D)``.

    ``generator`` lives on the points' device.  The draws follow the JAX
    version's distribution (first seed uniform over valid points, then
    proportional to ``max(D^2, 1e-30)``) but not its random bits.
    """
    valid = (torch.ones(points.shape[0], device=points.device) if mask is None
             else mask.to(points.dtype))
    first = torch.multinomial(valid, 1, generator=generator)
    centers = [points[first[0]]]
    mind = torch.sum((points - centers[0]) ** 2, dim=1)
    for _ in range(1, k):
        idx = torch.multinomial(torch.clamp_min(mind, 1e-30) * valid, 1, generator=generator)
        c = points[idx[0]]
        centers.append(c)
        mind = torch.minimum(mind, torch.sum((points - c) ** 2, dim=1))
    return torch.stack(centers)


def kmeans(
    generator: torch.Generator,
    points: torch.Tensor,
    k: int,
    iters: int = 64,
    mask: torch.Tensor | None = None,
    n_init: int = 4,
    seed_mode: str = "kmeans++",
) -> KMeansResult:
    """k-means with ``n_init`` restarts, best inertia wins.

    ``seed_mode="kmeans++"``: D^2-weighted seeding (reference parity); the
    restarts run as one batched :func:`lloyd`.  ``seed_mode="fps"``:
    farthest-point seeding over the first three feature columns, which
    spreads the seeds over the surface whatever the sampling density, so
    every geometrically distinct part gets a seed; deterministic, one run.
    """
    if seed_mode == "fps":
        idx = farthest_point_sample(points[:, :3], k, mask)
        return lloyd(points, points[idx], iters, mask)
    if seed_mode != "kmeans++":
        raise ValueError(f"unknown seed_mode {seed_mode!r}")
    inits = torch.stack([kmeans_plusplus_init(generator, points, k, mask)
                         for _ in range(n_init)])
    n, d = points.shape
    res = lloyd(points.expand(n_init, n, d), inits, iters,
                None if mask is None else mask.expand(n_init, n))
    best = torch.argmin(res.inertia)
    return KMeansResult(res.centers[best], res.labels[best], res.inertia[best])
