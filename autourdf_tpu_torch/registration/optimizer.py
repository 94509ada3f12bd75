"""Per-frame pose optimization, batched over sequences (port of
autourdf_tpu.registration.optimizer).

The reference's hot loop: Adam epochs of MLP forward, label-gathered
cluster transform, Chamfer-L1, backward, Adam, ReduceLROnPlateau,
best-pose tracking and early-stop freeze.  Every sequence of a batch
trains its own MLP with its own learning rate, plateau state, best loss
and freeze flag, so the optimizer is a hand-written Adam over one flat
``(S, P)`` parameter tensor (``torch.optim.Adam`` has one lr per param
group).  The epoch loop never waits on the host: no ``.item()``, no branch
on a tensor; the freeze is a ``torch.where`` pass-through.

Semantics, as in the JAX module:
- the loss is evaluated *before* the parameter update each epoch, and the
  best (loss, poses) pair over all epochs is returned;
- Adam(lr) with torch defaults; ReduceLROnPlateau(mode=min, factor=0.7,
  patience=5, rel threshold 1e-4);
- early stop after ``stop_patience`` epochs without a new best: later
  epochs freeze (the carry passes through), matching the reference's break.

:func:`train_pose_mlp` runs as the JAX driver's ``_batched_phases`` does:
a start program (``train_init``) and chunk programs of
:func:`train_epochs`, ``dispatch_epochs`` epochs each, captured once per
shape as CUDA graphs and replayed (``utils/programs.py``; on the CPU the same
programs run without capture).  ``eager=True`` runs the plain loop, the
reference the programs are held against.

On the card everything an epoch does after its loss and gradient (Adam, the
plateau step, best tracking, the early-stop freeze) is one launch of
``epoch_update_kernel`` (``csrc/optim.cu``), fed one gradient a parameter
tensor (:func:`epoch_update`); on the CPU it is the plain chain of PyTorch
operations (:func:`_epoch_update_plain`), the reference the kernel is held to
bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from ..ops import _cuda
from ..ops.chamfer import (_ChamferFn, chamfer_correspondences, chamfer_distance,
                           chamfer_from_indices)
from ..utils import programs


def apply_pose_rows(rows: torch.Tensor, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-point affine apply of per-cluster ``(..., K, 3, 4)`` pose rows to
    ``points (..., N, 3)`` with ``labels (..., N)``.

    Rows are selected with a one-hot matmul, as in the JAX version: the
    selection is exact (one product by 1, the rest by 0), and its backward
    is a matmul, whose sums come out the same every run on the card (a
    gather's backward adds with float atomics there, in arrival order).
    """
    flat = rows.flatten(-2)                                            # (..., K, 12)
    K = flat.shape[-2]
    onehot = (labels[..., None] == torch.arange(K, device=labels.device)).to(flat.dtype)
    sel = torch.matmul(onehot, flat).unflatten(-1, (3, 4))             # (..., N, 3, 4)
    return torch.sum(sel[..., :3] * points[..., None, :], dim=-1) + sel[..., 3]


def transform_by_labels(matrices: torch.Tensor, points: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """World points ``R[label] @ p + t[label]`` for flat points and labels."""
    return apply_pose_rows(matrices[..., :3, :], points, labels)


class AdamState(NamedTuple):
    mu: torch.Tensor    # (S, P)
    nu: torch.Tensor    # (S, P)
    step: torch.Tensor  # (S,) int32


def adam_init(theta: torch.Tensor) -> AdamState:
    return AdamState(torch.zeros_like(theta), torch.zeros_like(theta),
                     torch.zeros(theta.shape[0], dtype=torch.int32, device=theta.device))


# Adam's torch defaults and the plateau's relative threshold
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
PLATEAU_THRESHOLD = 1e-4


def adam_update(grads: torch.Tensor, state: AdamState, theta: torch.Tensor, lr: torch.Tensor,
                b1: float = ADAM_B1, b2: float = ADAM_B2, eps: float = ADAM_EPS):
    """One Adam step per sequence; ``lr (S,)``.  Same formula and order of
    operations as the JAX ``adam_update``."""
    step = state.step + 1
    mu = b1 * state.mu + (1 - b1) * grads
    nu = b2 * state.nu + (1 - b2) * grads * grads
    t = step.to(torch.float32)[:, None]
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    new_theta = theta - lr[:, None] * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    return new_theta, AdamState(mu, nu, step)


class PlateauState(NamedTuple):
    best: torch.Tensor     # (S,) scheduler-tracked best loss
    num_bad: torch.Tensor  # (S,) int32 epochs since scheduler best
    lr: torch.Tensor       # (S,)


def plateau_init(lr: float, num_seqs: int, device) -> PlateauState:
    return PlateauState(
        torch.full((num_seqs,), float("inf"), device=device),
        torch.zeros(num_seqs, dtype=torch.int32, device=device),
        torch.full((num_seqs,), lr, dtype=torch.float32, device=device),
    )


def plateau_update(state: PlateauState, loss: torch.Tensor, factor: float = 0.7,
                   patience: int = 5, threshold: float = PLATEAU_THRESHOLD) -> PlateauState:
    """torch ReduceLROnPlateau (mode=min, rel threshold) semantics, per sequence."""
    improved = loss < state.best * (1.0 - threshold)
    best = torch.where(improved, loss, state.best)
    num_bad = torch.where(improved, 0, state.num_bad + 1)
    reduce = num_bad > patience
    lr = torch.where(reduce, state.lr * factor, state.lr)
    num_bad = torch.where(reduce, 0, num_bad).to(torch.int32)
    return PlateauState(best, num_bad, lr)


class TrainCarry(NamedTuple):
    theta: torch.Tensor      # (S, P) flat MLP parameters
    opt: AdamState
    sched: PlateauState
    best_loss: torch.Tensor  # (S,)
    best_m: torch.Tensor     # (S, K, 4, 4)
    bad_count: torch.Tensor  # (S,) int32
    stopped: torch.Tensor    # (S,) bool


class TrainResult(NamedTuple):
    params: torch.Tensor         # (S, P) final flat MLP params (carried to the next frame)
    best_matrices: torch.Tensor  # (S, K, 4, 4) best poses found
    best_loss: torch.Tensor      # (S,)
    loss_history: torch.Tensor   # (S, epochs) per-epoch losses (inf past early stop)


def train_init(theta: torch.Tensor, matrices: torch.Tensor, learning_rate: float) -> TrainCarry:
    S, dev = theta.shape[0], theta.device
    return TrainCarry(
        theta=theta.detach(),
        opt=adam_init(theta.detach()),
        sched=plateau_init(learning_rate, S, dev),
        best_loss=torch.full((S,), float("inf"), device=dev),
        best_m=matrices,
        bad_count=torch.zeros(S, dtype=torch.int32, device=dev),
        stopped=torch.zeros(S, dtype=torch.bool, device=dev),
    )


def predict_points(model, theta: torch.Tensor | dict[str, torch.Tensor], matrices: torch.Tensor,
                   points: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The pose MLP's matrices ``(S, K, 4, 4)`` from the flat ``theta`` (or
    its per-parameter tensors, ``model.unflatten``'s dict) and the incoming
    ``matrices``, and the world points ``(S, N, 3)`` they pose."""
    m2 = model.forward_flat(theta, matrices)
    return m2, transform_by_labels(m2, points, labels)


def _keep_old(frozen: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(frozen.view((-1,) + (1,) * (new.dim() - 1)), old, new)


def _epoch_step(c: TrainCarry, loss_and_m, model, stop_patience, scheduler_patience,
                scheduler_factor) -> tuple[TrainCarry, torch.Tensor]:
    """One epoch: the loss of ``c.theta`` and its gradient, one piece a
    parameter on the card (:func:`loss_and_grads`), then
    :func:`epoch_update`."""
    loss, m2, grads = loss_and_grads(c.theta, loss_and_m, model, c.theta.is_cuda)
    return epoch_update(c, grads, loss, m2, stop_patience, scheduler_patience, scheduler_factor)


def loss_and_grads(theta: torch.Tensor, loss_and_m, model, per_parameter: bool):
    """``loss_and_m(params) -> (loss (S,), m2)`` and the gradient of the
    loss's sum, detached: ``(loss, m2, grads)``.  ``params`` is the flat
    ``theta``, and ``grads`` its one gradient; or, ``per_parameter``,
    ``model.unflatten``'s dict of views of ``theta``, each a leaf, and
    ``grads`` one a parameter as its GEMM or bias sum wrote it, where the
    gradient against the flat tensor zero-fills an ``(S, P)`` tensor a
    parameter and adds them up.  The values are the same."""
    if per_parameter:
        params = model.unflatten(theta.detach())
        wrt = [p.requires_grad_(True) for p in params.values()]
    else:
        params = theta.detach().requires_grad_(True)
        wrt = [params]
    with torch.enable_grad():
        loss, m2 = loss_and_m(params)
        grads = torch.autograd.grad(loss.sum(), wrt)
    return loss.detach(), m2.detach(), grads


def epoch_update(c: TrainCarry, grads: Sequence[torch.Tensor], loss: torch.Tensor,
                 m2: torch.Tensor, stop_patience: int, scheduler_patience: int,
                 scheduler_factor: float) -> tuple[TrainCarry, torch.Tensor]:
    """An epoch's step after its ``loss (S,)``, poses ``m2 (S, K, 4, 4)``
    and gradient: Adam, the plateau step, best tracking and the early-stop
    freeze.  ``grads`` are the gradient's pieces in the order of theta's
    columns (:func:`update_segments`): the flat ``(S, P)`` gradient, or one
    tensor a parameter.  Returns the new carry and the loss, ``inf`` where
    the sequence was already frozen.  One launch of ``epoch_update_kernel``
    on CUDA tensors, the plain chain on CPU tensors."""
    if c.theta.is_cuda:
        return _epoch_update_cuda(c, grads, loss, m2, stop_patience, scheduler_patience,
                                  scheduler_factor)
    table = update_segments(grads, *c.theta.shape)
    flat = table[0][0] if len(table) == 1 else torch.cat([g for g, _ in table], dim=1)
    return _epoch_update_plain(c, flat, loss, m2, stop_patience, scheduler_patience,
                               scheduler_factor)


def update_segments(grads: Sequence[torch.Tensor], S: int, P: int) -> list[tuple[torch.Tensor,
                                                                                  int]]:
    """The segment table of :func:`epoch_update`: each gradient piece as an
    ``(S, n)`` tensor with the first of the columns ``[offset, offset + n)``
    of theta's rows that it covers; raises unless the pieces tile
    ``[0, P)``."""
    table, off = [], 0
    for g in grads:
        if g.dim() < 2 or g.shape[0] != S:
            raise ValueError(f"a gradient piece of shape {tuple(g.shape)} for {S} sequences")
        g = g.reshape(S, -1)
        table.append((g, off))
        off += g.shape[1]
    if off != P:
        raise ValueError(f"the gradient pieces cover {off} columns of theta's {P}")
    return table


def _epoch_update_plain(c: TrainCarry, grads: torch.Tensor, loss: torch.Tensor,
                        m2: torch.Tensor, stop_patience, scheduler_patience,
                        scheduler_factor) -> tuple[TrainCarry, torch.Tensor]:
    """Plain version of ``epoch_update_kernel``, with the flat gradient
    ``grads (S, P)``."""
    improved = loss < c.best_loss
    best_loss = torch.where(improved, loss, c.best_loss)
    best_m = _keep_old(~improved, m2, c.best_m)
    bad_count = torch.where(improved, 0, c.bad_count + 1).to(torch.int32)
    stop_now = bad_count > stop_patience

    # torch ordering: optimizer.step() runs with the current lr, then
    # scheduler.step(loss): a plateau reduction takes effect NEXT epoch
    new_theta, opt = adam_update(grads, c.opt, c.theta, c.sched.lr)
    sched = plateau_update(c.sched, loss, scheduler_factor, scheduler_patience)

    # Early-stop freeze: past the stop point the carry passes through
    # unchanged (the reference's loop break)
    frozen = c.stopped
    keep = lambda new, old: _keep_old(frozen, new, old)
    out = TrainCarry(
        theta=keep(new_theta, c.theta),
        opt=AdamState(*(keep(n, o) for n, o in zip(opt, c.opt))),
        sched=PlateauState(*(keep(n, o) for n, o in zip(sched, c.sched))),
        best_loss=keep(best_loss, c.best_loss),
        best_m=keep(best_m, c.best_m),
        bad_count=keep(bad_count, c.bad_count),
        stopped=frozen | stop_now,
    )
    return out, torch.where(frozen, float("inf"), loss)


# the segments a launch of epoch_update_kernel takes (csrc/optim.cu)
UPDATE_MAX_SEGMENTS = 16


def _epoch_update_cuda(c: TrainCarry, grads: Sequence[torch.Tensor], loss: torch.Tensor,
                       m2: torch.Tensor, stop_patience, scheduler_patience,
                       scheduler_factor) -> tuple[TrainCarry, torch.Tensor]:
    """Stands for the XLA-fused ``adam_update`` / ``_epoch_step`` of
    autourdf_tpu/registration/optimizer.py (no Pallas kernel): one launch of
    ``epoch_update_kernel`` (csrc/optim.cu) reads each gradient piece where
    autograd left it and writes a fresh carry."""
    S, P = c.theta.shape
    table = update_segments(grads, S, P)
    if len(table) > UPDATE_MAX_SEGMENTS:
        raise ValueError(f"epoch_update_kernel takes at most {UPDATE_MAX_SEGMENTS} gradient "
                         f"pieces, got {len(table)}")
    ins = [c.theta, c.opt.mu, c.opt.nu, c.opt.step, c.sched.best, c.sched.lr, c.sched.num_bad,
           c.best_loss, c.best_m, m2, loss, c.bad_count, c.stopped]
    kinds = [torch.float32] * 3 + [torch.int32] + [torch.float32] * 2 + [torch.int32] \
        + [torch.float32] * 4 + [torch.int32, torch.bool]
    shapes = [(S, P)] * 3 + [(S,)] * 5 + [c.best_m.shape, c.best_m.shape, (S,), (S,), (S,)]
    for t, kind, shape in zip(ins + [g for g, _ in table], kinds + [torch.float32] * len(table),
                              shapes + [(S, g.shape[1]) for g, _ in table]):
        if t.dtype != kind or tuple(t.shape) != tuple(shape) or t.device != c.theta.device:
            raise ValueError(f"epoch_update_kernel: a {t.dtype} {tuple(t.shape)} tensor on "
                             f"{t.device} where it takes {kind} {tuple(shape)} on "
                             f"{c.theta.device}")
    ins = [t.contiguous() for t in ins]
    pieces = [g.contiguous() for g, _ in table]
    outs = [torch.empty_like(t) for t in ins[:9] + ins[11:] + ins[10:11]]
    lib = _cuda.library("optim")
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    offsets = (ctypes.c_int * (len(table) + 1))(*[o for _, o in table], P)
    err = _cuda.launch(
        lib.optim_epoch_update_launch, c.theta, ptrs(pieces), offsets, len(table), ptrs(ins),
        ptrs(outs), S, P, c.best_m[0].numel(), ADAM_B1, 1 - ADAM_B1, ADAM_B2, 1 - ADAM_B2,
        ADAM_EPS, 1.0 - PLATEAU_THRESHOLD, scheduler_factor, stop_patience, scheduler_patience,
        _cuda.stream(c.theta))
    _cuda.check(err, "epoch_update_kernel launch")
    _cuda.launch_counts["epoch_update"] += 1
    theta, mu, nu, step, best, lr, num_bad, best_loss, best_m, bad_count, stopped, masked = outs
    return TrainCarry(theta, AdamState(mu, nu, step), PlateauState(best, num_bad, lr), best_loss,
                      best_m, bad_count, stopped), masked


def train_epochs(
    model,
    carry: TrainCarry,
    matrices: torch.Tensor,
    target: torch.Tensor,
    points: torch.Tensor,
    labels: torch.Tensor,
    num_epochs: int,
    target_mask: torch.Tensor | None = None,
    points_mask: torch.Tensor | None = None,
    stop_patience: int = 200,
    scheduler_patience: int = 5,
    scheduler_factor: float = 0.7,
    corr_every: int = 1,
    chamfer_fn=None,
) -> tuple[TrainCarry, torch.Tensor]:
    """Advance the optimization by ``num_epochs``; returns ``(carry, losses
    (S, num_epochs))``.

    ``model`` is a :class:`~autourdf_tpu_torch.models.regmlp.PoseRegressor`
    that gives the network's structure; its parameters are the carry's
    flat ``theta``.  ``matrices (S, K, 4, 4)`` are the incoming poses,
    ``points (S, N, 3)`` + ``labels (S, N)`` the flat local-frame cluster
    points, ``target (S, M, 3)`` the next frame.

    ``corr_every > 1`` refreshes the nearest-neighbour correspondences once
    per round of ``corr_every`` epochs; the epochs in between optimize the
    gathered (projected) Chamfer, an upper bound that touches the true loss
    at each refresh.

    ``chamfer_fn(pred, target, points_mask, target_mask) -> loss (S,)``
    overrides the loss (``corr_every == 1`` only): the hook through which
    ``parallel.sharding.train_step_dp_sp`` substitutes the Chamfer whose
    search is split over the sp ranks.
    """
    steps = (stop_patience, scheduler_patience, scheduler_factor)

    def predict(theta):
        return predict_points(model, theta, matrices, points, labels)

    losses = []
    if corr_every <= 1:
        if chamfer_fn is None:
            def chamfer_fn(pred, tgt, pm, tm):
                return chamfer_distance(pred, tgt, pm, tm, norm=1)

        def loss_and_m(theta):
            m2, pred = predict(theta)
            return chamfer_fn(pred, target, points_mask, target_mask), m2

        for _ in range(num_epochs):
            carry, loss = _epoch_step(carry, loss_and_m, model, *steps)
            losses.append(loss)
        return carry, torch.stack(losses, dim=1)

    if chamfer_fn is not None:
        raise ValueError("chamfer_fn override requires corr_every == 1")
    if num_epochs % corr_every != 0:
        raise ValueError(
            f"num_epochs={num_epochs} must be a multiple of corr_every={corr_every}")
    for _ in range(num_epochs // corr_every):
        with torch.no_grad():
            _, pred0 = predict(carry.theta)
        ix, iy = chamfer_correspondences(pred0, target, points_mask, target_mask, norm=1)

        def loss_and_m(theta, ix=ix, iy=iy):
            m2, pred = predict(theta)
            return chamfer_from_indices(pred, target, ix, iy, points_mask, target_mask,
                                        norm=1), m2

        for _ in range(corr_every):
            carry, loss = _epoch_step(carry, loss_and_m, model, *steps)
            losses.append(loss)
    return carry, torch.stack(losses, dim=1)


def epoch_from_search(
    model,
    carry: TrainCarry,
    matrices: torch.Tensor,
    target: torch.Tensor,
    points: torch.Tensor,
    labels: torch.Tensor,
    found: tuple,
    stop_patience: int = 200,
    scheduler_patience: int = 5,
    scheduler_factor: float = 0.7,
) -> tuple[TrainCarry, torch.Tensor]:
    """One epoch of :func:`train_epochs` with ``chamfer_fn`` whose Chamfer
    search was made elsewhere, from the same ``carry.theta``: ``found`` is
    its ``(dx, ix, dy, iy)`` of the unmasked clouds.

    The Chamfer's forward takes the loss from ``dx`` and ``dy`` and its
    backward needs only ``ix`` and ``iy``, so the epoch's loss, gradient and
    carry are those of the epoch that searched for itself.  Used by
    ``parallel.sharding.train_step_dp_sp``, whose search ends in collectives
    that run between two programs.  Returns ``(carry, loss (S,))``."""
    xw = torch.ones(points.shape[:2], dtype=torch.float32, device=points.device)
    yw = torch.ones(target.shape[:2], dtype=torch.float32, device=target.device)

    def loss_and_m(theta):
        m2, pred = predict_points(model, theta, matrices, points, labels)
        return _ChamferFn.apply(pred, target, xw, yw, 1, lambda *_: found), m2

    return _epoch_step(carry, loss_and_m, model, stop_patience, scheduler_patience,
                       scheduler_factor)


def train_finalize(carry: TrainCarry, losses: torch.Tensor) -> TrainResult:
    return TrainResult(carry.theta, carry.best_m, carry.best_loss, losses)


def epoch_chunks(epochs: int, dispatch_epochs: int, corr_every: int = 1) -> list[int]:
    """The epochs of each training program call: ``dispatch_epochs``
    rounded down to whole rounds of ``corr_every`` (at least one round), the
    last chunk shorter, as the JAX driver cuts them
    (``autourdf_tpu/registration/pipeline.py`` ``train_phase``)."""
    ce = max(1, corr_every)
    chunk = max(ce, (dispatch_epochs // ce) * ce)
    return [min(chunk, epochs - done) for done in range(0, epochs, chunk)]


def train_pose_mlp(
    model,
    theta: torch.Tensor,
    matrices: torch.Tensor,
    target: torch.Tensor,
    points: torch.Tensor,
    labels: torch.Tensor,
    target_mask: torch.Tensor | None = None,
    points_mask: torch.Tensor | None = None,
    epochs: int = 300,
    learning_rate: float = 2e-4,
    stop_patience: int = 200,
    scheduler_patience: int = 5,
    scheduler_factor: float = 0.7,
    corr_every: int = 1,
    dispatch_epochs: int = 100,
    eager: bool = False,
) -> TrainResult:
    """Optimize the pose MLPs of a sequence batch against one target frame.

    ``theta (S, P)`` are the flat parameters (``model.flat_params()``);
    ``matrices`` are the incoming poses, the MLP input every epoch (the
    reference re-clones them each epoch and never feeds back its output).
    The start program and the chunk programs of :func:`epoch_chunks` run
    the epochs (a shorter last chunk is a program of its own); ``eager=True``
    runs them as one plain loop instead.
    """
    steps = (stop_patience, scheduler_patience, scheduler_factor)
    if eager:
        carry = train_init(theta, matrices, learning_rate)
        carry, losses = train_epochs(model, carry, matrices, target, points, labels, epochs,
                                     target_mask, points_mask, *steps, corr_every)
        return train_finalize(carry, losses)

    carry = programs.run(("train_init", learning_rate),
                         lambda th, m: train_init(th, m, learning_rate), theta, matrices)
    losses = []
    # the correspondence-refresh rounds are other operations: another family
    family = "train_epochs" if corr_every <= 1 else "train_epochs_rounds"
    for n in epoch_chunks(epochs, dispatch_epochs, corr_every):
        def chunk(c, m, tgt, pts, lab, tm, pm, n=n):
            return train_epochs(model, c, m, tgt, pts, lab, n, tm, pm, *steps, corr_every)

        carry, chunk_losses = programs.run(
            (family, model.mode, model.hidden_dim, n, *steps, corr_every), chunk,
            carry, matrices, target, points, labels, target_mask, points_mask,
            warm=functools.partial(chunk, n=max(1, corr_every)))
        losses.append(chunk_losses.clone())
    return train_finalize(programs.clone(carry), torch.cat(losses, dim=1))
