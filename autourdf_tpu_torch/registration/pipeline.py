"""Whole-sequence cluster registration, batched over sequences (port of
autourdf_tpu.registration.pipeline).

The reference driver ``match()``: per frame pair, a step-phase fit of the
pose MLP (current clusters -> next frame), an anchor-phase fit (frame-0
clusters -> next frame, drift correction) and a warm-started k-means
resample of the next frame around the updated centres.  All sequences run
together: every tensor carries a leading ``S`` axis and each training
epoch is one batched Chamfer kernel launch for all of them.  Both MLPs of
a sequence persist across its frames, as in the reference.

The JAX module has three drivers with the same math:
``register_sequences_batched`` (per-phase dispatch), ``register_sequence``
(one ``lax.scan`` program for one sequence) and ``register_sequences_fused``
(one program for all sequences).  The two single-program forms exist for
the TPU's dispatch model; PyTorch runs eagerly, so here they are thin
aliases of :func:`register_sequences_batched`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.icp import masked_icp_clusters
from ..ops.kmeans import lloyd
from ..ops.plane import estimate_normals
from .optimizer import train_pose_mlp, transform_by_labels
from .segments import SegmentInit, local_points_from_labels


class RegistrationConfig(NamedTuple):
    num_seg: int = 20
    mode: str = "q"
    hidden_dim: int = 512
    epochs: int = 300
    lr_step: float = 2e-4
    lr_anchor: float = 1e-4
    stop_patience: int = 200
    scheduler_patience: int = 5
    scheduler_factor: float = 0.7
    kmeans_iters: int = 32
    mlp_icp: bool = False          # step train -> masked per-cluster ICP
    icp_iterations: int = 30
    icp_box_scale: float = 1.2
    dispatch_epochs: int = 100     # accepted for parity; no effect in eager mode
    use_normals: bool = False      # 6-D k-means features (xyz + 0.5*normals)
    corr_every: int = 1            # NN-search refresh period (1 = every epoch,
                                   # reference-exact; >1 = amortized ICP-style)


class SequenceResult(NamedTuple):
    matrices: torch.Tensor      # (S, T, K, 4, 4) per-frame cluster poses
    local_points: torch.Tensor  # (S, T, N, 3) per-frame points in cluster frames
    labels: torch.Tensor        # (S, T, N) int64 cluster assignments
    losses: torch.Tensor        # (S, T-1) best anchor-phase Chamfer per frame pair
    step_losses: torch.Tensor   # (S, T-1) best step-phase Chamfer per frame pair


def register_sequences_batched(
    model,
    cfg: RegistrationConfig,
    step_params_batch: dict[str, torch.Tensor],
    anchor_params_batch: dict[str, torch.Tensor],
    init: SegmentInit,
    frames: torch.Tensor,              # (S, T, N, 3)
    masks: torch.Tensor | None = None,  # (S, T, N) for ragged frames
) -> SequenceResult:
    """Register all sequences of ``frames`` against the shared ``init``.

    ``model`` is a :class:`~autourdf_tpu_torch.models.regmlp.PoseRegressor`
    of ``cfg.mode``/``cfg.hidden_dim``; ``step_params_batch`` and
    ``anchor_params_batch`` are state dicts shaped like its parameters with
    a leading ``S`` axis (one MLP per sequence).  ``init`` holds the shared
    frame-0 segmentation; ``frames[:, 0]`` is the frame it came from.
    Returns per-frame results with the frame-0 state prepended.
    """
    S, T = frames.shape[0], frames.shape[1]
    tile = lambda x: x[None].expand((S,) + x.shape)
    matrices = tile(init.matrices)
    points = tile(init.points)
    labels = tile(init.labels)
    anchor_points, anchor_labels = points, labels
    step_theta = model.flat_params(step_params_batch)
    anchor_theta = model.flat_params(anchor_params_batch)

    # init.points came from ONE frame (usually sequence 0's frame 0): its
    # own mask must ride along; per-sequence masks[:, 0] would mark rows
    # valid that are sentinel padding in init.points
    if masks is not None:
        im = init.mask if init.mask is not None else masks[0, 0]
        points_mask = tile(im)
    else:
        points_mask = None
    anchor_mask = points_mask

    train = dict(epochs=cfg.epochs, stop_patience=cfg.stop_patience,
                 scheduler_patience=cfg.scheduler_patience,
                 scheduler_factor=cfg.scheduler_factor, corr_every=cfg.corr_every)
    out_m, out_p, out_l = [matrices], [points], [labels]
    out_loss, out_step_loss = [], []
    for i in range(T - 1):
        target = frames[:, i + 1]
        target_mask = masks[:, i + 1] if masks is not None else None
        step_res = train_pose_mlp(model, step_theta, matrices, target, points, labels,
                                  target_mask, points_mask, learning_rate=cfg.lr_step, **train)
        step_theta = step_res.params
        if cfg.mlp_icp:
            # MLP+ICP variant: refine each cluster pose with AABB-masked p2p
            # ICP instead of the anchor MLP, all S * K clusters as one batch
            new_m = masked_icp_clusters(points, labels, step_res.best_matrices, target,
                                        num_clusters=cfg.num_seg, scale=cfg.icp_box_scale,
                                        max_iterations=cfg.icp_iterations)
            loss = step_res.best_loss
        else:
            anchor_res = train_pose_mlp(model, anchor_theta, step_res.best_matrices, target,
                                        anchor_points, anchor_labels, target_mask, anchor_mask,
                                        learning_rate=cfg.lr_anchor, **train)
            anchor_theta = anchor_res.params
            new_m = anchor_res.best_matrices
            loss = anchor_res.best_loss

        # resample: warm-started k-means of the target frame around the
        # updated centres, then re-express points in their cluster frames
        centres = new_m[..., :3, 3]
        if cfg.use_normals:
            normals = torch.stack([estimate_normals(t, k=30) for t in target])
            km = lloyd(torch.cat([target, 0.5 * normals], dim=-1),
                       torch.cat([centres, torch.zeros_like(centres)], dim=-1),
                       iters=cfg.kmeans_iters, mask=target_mask)
        else:
            km = lloyd(target, centres, iters=cfg.kmeans_iters, mask=target_mask)
        labels = km.labels
        points = local_points_from_labels(new_m, target, labels)
        points_mask = target_mask
        matrices = new_m
        out_m.append(matrices)
        out_p.append(points)
        out_l.append(labels)
        out_loss.append(loss)
        out_step_loss.append(step_res.best_loss)

    return SequenceResult(
        matrices=torch.stack(out_m, dim=1),
        local_points=torch.stack(out_p, dim=1),
        labels=torch.stack(out_l, dim=1),
        losses=torch.stack(out_loss, dim=1),
        step_losses=torch.stack(out_step_loss, dim=1),
    )


register_sequences_fused = register_sequences_batched
"""Alias of :func:`register_sequences_batched` (the JAX single-program form)."""


def register_sequence(model, cfg: RegistrationConfig, step_params, anchor_params,
                      init: SegmentInit, frames: torch.Tensor,
                      masks: torch.Tensor | None = None) -> SequenceResult:
    """One sequence ``frames (T, N, 3)``: the batched driver at ``S = 1``.

    Parameters may carry a leading ``S = 1`` axis or none; the result has
    none."""
    add = lambda p: {k: (v if v.dim() == getattr(model, k).dim() else v[None])
                     for k, v in p.items()}
    res = register_sequences_batched(model, cfg, add(step_params), add(anchor_params), init,
                                     frames[None], None if masks is None else masks[None])
    return SequenceResult(*(x[0] for x in res))


def predicted_world_points(result: SequenceResult, t: int) -> torch.Tensor:
    """The registered world-frame cloud at frame ``t`` (of every sequence of
    a batched result)."""
    return transform_by_labels(result.matrices.select(-4, t),
                               result.local_points.select(-3, t),
                               result.labels.select(-2, t))
