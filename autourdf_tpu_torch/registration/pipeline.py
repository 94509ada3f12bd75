"""Whole-sequence cluster registration, batched over sequences (port of
autourdf_tpu.registration.pipeline).

The reference driver ``match()``: per frame pair, a step-phase fit of the
pose MLP (current clusters -> next frame), an anchor-phase fit (frame-0
clusters -> next frame, drift correction) and a warm-started k-means
resample of the next frame around the updated centres.  All sequences run
together: every tensor carries a leading ``S`` axis and each training
epoch is one batched Chamfer kernel launch for all of them.  Both MLPs of
a sequence persist across its frames, as in the reference.

Three drivers with the same math, as in the JAX module, each a set of
device programs (``utils/programs.py``: CUDA graphs captured once per shape
and replayed on the card, the same functions run without capture on the
CPU):

- :func:`register_sequences_batched` dispatches one phase at a time, as the
  JAX driver's ``_batched_phases``: a start program and chunk programs of
  ``cfg.dispatch_epochs`` epochs per training phase, then a resample
  program;
- :func:`register_sequences_fused` captures the whole frame-pair body (step
  phase, anchor phase, resample: the JAX ``_frame_step``) as one program and
  replays it once per frame pair, the counterpart of its ``lax.scan``;
- :func:`register_sequence` is the fused driver at ``S = 1``.

Every phase of every configuration is in a program: the ``mlp_icp`` ICP
phase runs each iteration's Kabsch step in ``icp_kabsch_kernel`` and the
``use_normals`` resample its normals in ``pca_normals_kernel``
(``csrc/geom.cu``), so neither waits on the host.
``register_sequences_batched(..., eager=True)`` runs the plain loops, the
reference the programs are held against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.icp import masked_icp_clusters
from ..ops.kmeans import lloyd
from ..ops.plane import estimate_normals
from ..utils import programs
from ..utils.telemetry import span
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
    dispatch_epochs: int = 100     # epochs a training program advances (a graph's chunk)
    use_normals: bool = False      # 6-D k-means features (xyz + 0.5*normals)
    corr_every: int = 1            # NN-search refresh period (1 = every epoch,
                                   # reference-exact; >1 = amortized ICP-style)


class SequenceResult(NamedTuple):
    matrices: torch.Tensor      # (S, T, K, 4, 4) per-frame cluster poses
    local_points: torch.Tensor  # (S, T, N, 3) per-frame points in cluster frames
    labels: torch.Tensor        # (S, T, N) int64 cluster assignments
    losses: torch.Tensor        # (S, T-1) best anchor-phase Chamfer per frame pair
    step_losses: torch.Tensor   # (S, T-1) best step-phase Chamfer per frame pair


def _tile(x: torch.Tensor | None, S: int) -> torch.Tensor | None:
    return None if x is None else x[None].expand((S,) + x.shape)


def _start(model, init: SegmentInit, step_params_batch, anchor_params_batch,
           frames: torch.Tensor, masks: torch.Tensor | None):
    """The frame-0 state shared by the drivers: the init tiled over the
    sequences (labels as int64, the resample's type, so every frame pair
    meets the same programs) and the flat MLP parameters."""
    S = frames.shape[0]
    # init.points came from ONE frame (usually sequence 0's frame 0): its
    # own mask must ride along; per-sequence masks[:, 0] would mark rows
    # valid that are sentinel padding in init.points
    im = None if masks is None else (init.mask if init.mask is not None else masks[0, 0])
    return (model.flat_params(step_params_batch), model.flat_params(anchor_params_batch),
            _tile(init.matrices, S), _tile(init.points, S), _tile(init.labels.long(), S),
            _tile(im, S))


def _train(model, cfg: RegistrationConfig, theta, matrices, target, points, labels,
           target_mask, points_mask, lr: float, eager: bool = True):
    return train_pose_mlp(model, theta, matrices, target, points, labels, target_mask,
                          points_mask, epochs=cfg.epochs, learning_rate=lr,
                          stop_patience=cfg.stop_patience,
                          scheduler_patience=cfg.scheduler_patience,
                          scheduler_factor=cfg.scheduler_factor, corr_every=cfg.corr_every,
                          dispatch_epochs=cfg.dispatch_epochs, eager=eager)


def _icp(cfg: RegistrationConfig, points, labels, matrices, target):
    """The MLP+ICP variant's refinement: AABB-masked p2p ICP of each cluster
    pose instead of the anchor MLP, all S * K clusters as one batch."""
    return masked_icp_clusters(points, labels, matrices, target, num_clusters=cfg.num_seg,
                               scale=cfg.icp_box_scale, max_iterations=cfg.icp_iterations)


def _icp_phase(cfg: RegistrationConfig, points, labels, matrices, target, eager: bool):
    """:func:`_icp` as a program (the JAX driver's ``icp_phase``), or eagerly
    for the plain loop; the first capture warms up on one ICP iteration."""
    if eager:
        return _icp(cfg, points, labels, matrices, target)
    one = cfg._replace(icp_iterations=1)
    return programs.clone(programs.run(
        ("icp_phase", cfg.num_seg, cfg.icp_box_scale, cfg.icp_iterations),
        lambda *a: _icp(cfg, *a), points, labels, matrices, target,
        warm=lambda *a: _icp(one, *a)))


def _resample(cfg: RegistrationConfig, new_m, target, target_mask):
    """Warm-started k-means of the target frame around the updated centres,
    then the points re-expressed in their cluster frames."""
    centres = new_m[..., :3, 3]
    if cfg.use_normals:
        normals = torch.stack([estimate_normals(t, k=30) for t in target])
        km = lloyd(torch.cat([target, 0.5 * normals], dim=-1),
                   torch.cat([centres, torch.zeros_like(centres)], dim=-1),
                   iters=cfg.kmeans_iters, mask=target_mask)
    else:
        km = lloyd(target, centres, iters=cfg.kmeans_iters, mask=target_mask)
    return local_points_from_labels(new_m, target, km.labels), km.labels


def _resample_phase(cfg: RegistrationConfig, new_m, target, target_mask, eager: bool):
    """:func:`_resample` as a program (the JAX driver's ``resample_phase``),
    or eagerly for the plain loop."""
    if eager:
        return _resample(cfg, new_m, target, target_mask)
    return programs.clone(programs.run(
        ("resample", cfg.kmeans_iters, cfg.use_normals),
        lambda m, t, tm: _resample(cfg, m, t, tm), new_m, target, target_mask))


def _result(out_m, out_p, out_l, out_loss, out_step_loss) -> SequenceResult:
    return SequenceResult(
        matrices=torch.stack(out_m, dim=1),
        local_points=torch.stack(out_p, dim=1),
        labels=torch.stack(out_l, dim=1),
        losses=torch.stack(out_loss, dim=1),
        step_losses=torch.stack(out_step_loss, dim=1),
    )


def register_sequences_batched(
    model,
    cfg: RegistrationConfig,
    step_params_batch: dict[str, torch.Tensor],
    anchor_params_batch: dict[str, torch.Tensor],
    init: SegmentInit,
    frames: torch.Tensor,              # (S, T, N, 3)
    masks: torch.Tensor | None = None,  # (S, T, N) for ragged frames
    eager: bool = False,
) -> SequenceResult:
    """Register all sequences of ``frames`` against the shared ``init``,
    one phase program at a time (``eager=True``: the plain loops).

    ``model`` is a :class:`~autourdf_tpu_torch.models.regmlp.PoseRegressor`
    of ``cfg.mode``/``cfg.hidden_dim``; ``step_params_batch`` and
    ``anchor_params_batch`` are state dicts shaped like its parameters with
    a leading ``S`` axis (one MLP per sequence).  ``init`` holds the shared
    frame-0 segmentation; ``frames[:, 0]`` is the frame it came from.
    Returns per-frame results with the frame-0 state prepended.
    """
    T = frames.shape[1]
    step_theta, anchor_theta, matrices, points, labels, points_mask = _start(
        model, init, step_params_batch, anchor_params_batch, frames, masks)
    anchor_points, anchor_labels, anchor_mask = points, labels, points_mask

    out_m, out_p, out_l = [matrices], [points], [labels]
    out_loss, out_step_loss = [], []
    for i in range(T - 1):
        target = frames[:, i + 1]
        target_mask = masks[:, i + 1] if masks is not None else None
        with span("register.phase", pair=i, kind="step"):
            step_res = _train(model, cfg, step_theta, matrices, target, points, labels,
                              target_mask, points_mask, cfg.lr_step, eager)
        step_theta = step_res.params
        if cfg.mlp_icp:
            with span("register.phase", pair=i, kind="icp"):
                new_m = _icp_phase(cfg, points, labels, step_res.best_matrices, target, eager)
            loss = step_res.best_loss
        else:
            with span("register.phase", pair=i, kind="anchor"):
                anchor_res = _train(model, cfg, anchor_theta, step_res.best_matrices, target,
                                    anchor_points, anchor_labels, target_mask, anchor_mask,
                                    cfg.lr_anchor, eager)
            anchor_theta = anchor_res.params
            new_m = anchor_res.best_matrices
            loss = anchor_res.best_loss
        with span("register.resample", device=True):
            points, labels = _resample_phase(cfg, new_m, target, target_mask, eager)
        points_mask = target_mask
        matrices = new_m
        out_m.append(matrices)
        out_p.append(points)
        out_l.append(labels)
        out_loss.append(loss)
        out_step_loss.append(step_res.best_loss)
    return _result(out_m, out_p, out_l, out_loss, out_step_loss)


def _frame_pair(model, cfg: RegistrationConfig, state, anchor, target, target_mask):
    """The whole frame-pair body (``_frame_step`` of the JAX module: the step
    phase, then the anchor phase or, with ``mlp_icp``, the ICP, then the
    resample), plain loops for capture as one program: the next state and
    the pair's ``(loss, step loss)``."""
    step_theta, anchor_theta, matrices, points, labels, points_mask = state
    step = _train(model, cfg, step_theta, matrices, target, points, labels, target_mask,
                  points_mask, cfg.lr_step)
    if cfg.mlp_icp:
        new_m = _icp(cfg, points, labels, step.best_matrices, target)
        loss = step.best_loss
    else:
        anchor_points, anchor_labels, anchor_mask = anchor
        res = _train(model, cfg, anchor_theta, step.best_matrices, target, anchor_points,
                     anchor_labels, target_mask, anchor_mask, cfg.lr_anchor)
        anchor_theta, new_m, loss = res.params, res.best_matrices, res.best_loss
    points, labels = _resample(cfg, new_m, target, target_mask)
    return (step.params, anchor_theta, new_m, points, labels, target_mask), loss, step.best_loss


def register_sequences_fused(
    model,
    cfg: RegistrationConfig,
    step_params_batch: dict[str, torch.Tensor],
    anchor_params_batch: dict[str, torch.Tensor],
    init: SegmentInit,
    frames: torch.Tensor,              # (S, T, N, 3)
    masks: torch.Tensor | None = None,  # (S, T, N) for ragged frames
) -> SequenceResult:
    """All sequences and frames with the frame-pair body as ONE program,
    replayed once per frame pair with the next frame and mask copied into
    its static target buffers (the JAX ``lax.scan``), in every configuration
    (``mlp_icp`` and ``use_normals`` included).  The same arguments and
    result as :func:`register_sequences_batched`.
    """
    T = frames.shape[1]
    state = _start(model, init, step_params_batch, anchor_params_batch, frames, masks)
    anchor = state[3:]
    key = (model.mode, model.hidden_dim, cfg)
    # the warm-up's: one round of epochs, one ICP iteration
    short = cfg._replace(epochs=max(1, cfg.corr_every), icp_iterations=1)

    out_m, out_p, out_l = [state[2]], [state[3]], [state[4]]
    out_loss, out_step_loss = [], []
    for i in range(T - 1):
        target = frames[:, i + 1]
        target_mask = masks[:, i + 1] if masks is not None else None
        state, loss, step_loss = programs.run(
            ("frame_pair", *key), lambda *a: _frame_pair(model, cfg, *a),
            state, anchor, target, target_mask,
            warm=lambda *a: _frame_pair(model, short, *a))
        out_m.append(state[2].clone())
        out_p.append(state[3].clone())
        out_l.append(state[4].clone())
        out_loss.append(loss.clone())
        out_step_loss.append(step_loss.clone())
    return _result(out_m, out_p, out_l, out_loss, out_step_loss)


def register_sequence(model, cfg: RegistrationConfig, step_params, anchor_params,
                      init: SegmentInit, frames: torch.Tensor,
                      masks: torch.Tensor | None = None) -> SequenceResult:
    """One sequence ``frames (T, N, 3)``: the fused driver at ``S = 1``.

    Parameters may carry a leading ``S = 1`` axis or none; the result has
    none."""
    add = lambda p: {k: (v if v.dim() == getattr(model, k).dim() else v[None])
                     for k, v in p.items()}
    res = register_sequences_fused(model, cfg, add(step_params), add(anchor_params), init,
                                   frames[None], None if masks is None else masks[None])
    return SequenceResult(*(x[0] for x in res))


def predicted_world_points(result: SequenceResult, t: int) -> torch.Tensor:
    """The registered world-frame cloud at frame ``t`` (of every sequence of
    a batched result)."""
    return transform_by_labels(result.matrices.select(-4, t),
                               result.local_points.select(-3, t),
                               result.labels.select(-2, t))
