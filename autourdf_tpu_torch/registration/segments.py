"""Initial cluster segmentation of frame 0 (port of
autourdf_tpu.registration.segments).

k-means++ over the first frame's points into ``num_seg`` clusters, each
cluster given an identity-rotation coordinate frame at its centre, and the
points expressed in that local frame.  Flat layout: points + labels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..ops.kmeans import kmeans
from ..ops.plane import estimate_normals
from .optimizer import apply_pose_rows, transform_by_labels


class SegmentInit(NamedTuple):
    matrices: torch.Tensor  # (K, 4, 4) identity-rotation frames at the centres
    points: torch.Tensor    # (N, 3) frame-0 points in their cluster's local frame
    labels: torch.Tensor    # (N,) int64 cluster assignment
    # validity mask for ``points`` (ragged frames).  This is THE mask that
    # must accompany these points everywhere: when the init is shared
    # across sequences, another sequence's frame-0 mask marks a different
    # set of rows valid and would let sentinel-padded rows into the loss.
    mask: torch.Tensor | None = None


def local_points_from_labels(matrices: torch.Tensor, world_points: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """Map world points into their assigned cluster's local frame."""
    inv = se3.inverse(matrices)
    return apply_pose_rows(inv[..., :3, :], world_points, labels)


def initial_segments(
    generator: torch.Generator,
    frame0: torch.Tensor,
    num_seg: int,
    mask: torch.Tensor | None = None,
    kmeans_iters: int = 64,
    n_init: int = 4,
    use_normals: bool = False,
    seed_mode: str = "kmeans++",
) -> SegmentInit:
    """Segment ``frame0 (N, 3)``; ``generator`` lives on its device.

    ``use_normals`` augments the k-means features with 0.5-scaled PCA
    normals (the reference's --normal mode).  ``seed_mode="fps"`` seeds
    density-independently (ops/kmeans.py) so small links get clusters.
    """
    feats = (torch.cat([frame0, 0.5 * estimate_normals(frame0, k=30)], dim=-1)
             if use_normals else frame0)
    res = kmeans(generator, feats, num_seg, iters=kmeans_iters, mask=mask,
                 n_init=n_init, seed_mode=seed_mode)
    # cluster frames: identity rotation at the k-means centre
    centers = res.centers[:, :3]
    matrices = torch.eye(4, dtype=frame0.dtype, device=frame0.device).repeat(num_seg, 1, 1)
    matrices[:, :3, 3] = centers
    local = frame0 - centers[res.labels]
    return SegmentInit(matrices, local, res.labels, mask)


def world_points(seg_matrices: torch.Tensor, points: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    return transform_by_labels(seg_matrices, points, labels)
