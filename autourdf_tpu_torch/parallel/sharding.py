"""Multi-process scaling over ``torch.distributed`` (port of
autourdf_tpu.parallel.sharding).

The JAX module lays a device mesh over the chips of one process and writes
its collectives inside ``shard_map``.  Here every rank is a process of the
default process group (``parallel.launch`` starts them), every rank calls
the same function with the same whole arguments, and a :class:`Mesh` gives
each named axis its own process group:

- **dp** (sequence axis): each dp rank registers its ``S / dp`` sequences
  and the results are assembled across dp, so every rank returns the whole
  result, as JAX's global arrays are whole.  No traffic between sequences.
- **sp** (point axis): the Chamfer's target cloud is cut across the sp
  ranks; each rank runs the bidirectional search kernel on its slice, the
  per-point minima combine with an all-reduce MIN and the directional sums
  with an all-reduce SUM.

Only ``all_reduce`` (MIN and SUM) is used, through :func:`all_reduce`: gloo
offers nothing else for CUDA tensors, and gloo is what several ranks on one
card need (NCCL refuses two ranks on one device).  An all-gather is an
all-reduce SUM of a zero buffer that holds the rank's own rows, which is
exact because it adds zeros.  The same code runs gloo on the CPU, gloo with
CUDA tensors and NCCL across cards.

JAX's second route to an active mesh (``jax.sharding.get_mesh``) has no
counterpart: a mesh is active only inside :class:`mesh_scope`.
"""

from __future__ import annotations

import itertools
import math
import os
from typing import Sequence

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}


class Mesh:
    """Named axes over the ranks of the default process group, row-major
    (the last axis varies fastest), with one process group per axis.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh.shape``
    does; ``index(axis)`` is this rank's coordinate along an axis;
    ``device`` is the device this rank computes on.
    """

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 device: torch.device):
        sizes, names = tuple(int(s) for s in axis_sizes), tuple(axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"axis sizes {sizes} and names {names} do not pair up")
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        coords = []
        rest = self.rank
        for s in reversed(sizes):
            coords.append(rest % s)
            rest //= s
        self.coords = dict(zip(names, reversed(coords)))
        # new_group must be entered by every rank, for every group, in the
        # same order; each rank keeps the group of its own line along an axis
        self.groups = {}
        strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        for a, name in enumerate(names):
            if sizes[a] == 1:
                continue
            others = [range(s) if i != a else range(1) for i, s in enumerate(sizes)]
            for base in itertools.product(*others):
                start = sum(c * st for c, st in zip(base, strides))
                ranks = [start + k * strides[a] for k in range(sizes[a])]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self.groups[name] = group

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.device})"


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              device: str | torch.device | None = None) -> Mesh:
    """Mesh over all ranks of the initialised default process group.

    ``device`` defaults to ``cuda:(local_rank % device_count)``, where the
    local rank is ``$LOCAL_RANK`` (else the global rank); pass ``"cpu"`` to
    compute on the CPU.  Every rank must call this, in the same order as its
    other meshes."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(parallel.launch.run starts one)")
    n = math.prod(int(s) for s in axis_sizes)
    if n != dist.get_world_size():
        raise ValueError(f"mesh {tuple(axis_sizes)} has {n} ranks, the process group "
                         f"{dist.get_world_size()}")
    if device is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device; pass device='cpu' to compute on the CPU")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % count)
    return Mesh(axis_sizes, axis_names, device)


# ---------------------------------------------------------------------------
# Active-mesh stack: ops.chamfer shards large clouds when a mesh with an sp
# axis larger than 1 is active.

_MESH_STACK: list[Mesh] = []


class mesh_scope:
    """``with mesh_scope(mesh):`` activates a mesh for auto-sharding."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __enter__(self) -> Mesh:
        _MESH_STACK.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        popped = _MESH_STACK.pop()
        if popped is not self.mesh:
            raise RuntimeError("mesh_scope exited out of order")
        return False


def active_mesh() -> Mesh | None:
    """The innermost mesh activated by :class:`mesh_scope`, else None."""
    return _MESH_STACK[-1] if _MESH_STACK else None


# ---------------------------------------------------------------------------
# Collectives

def all_reduce(mesh: Mesh, axis: str, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """All-reduce ``t`` in place over the ranks of ``axis`` (``op`` "sum" or
    "min"); returns it.  The port's one collective."""
    if mesh.shape[axis] > 1:
        dist.all_reduce(t, op=_OPS[op], group=mesh.groups[axis])
    return t


def _assemble(mesh: Mesh, axis: str, local: torch.Tensor, total: int) -> torch.Tensor:
    """Concatenate every rank's ``local`` rows along dim 0 in axis order: a
    SUM of zero buffers that each hold one rank's rows (exact)."""
    rows = local.shape[0]
    out = torch.zeros((total,) + local.shape[1:], dtype=local.dtype, device=local.device)
    start = mesh.index(axis) * rows
    out[start:start + rows] = local
    return all_reduce(mesh, axis, out)


def _tree_map(fn, tree):
    """``fn`` on every tensor of nested dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _rows(mesh: Mesh, axis: str, n: int) -> slice:
    k = mesh.shape[axis]
    if n % k:
        raise ValueError(f"{n} rows do not split over {axis}={k}")
    i = mesh.index(axis)
    return slice(i * (n // k), (i + 1) * (n // k))


def shard_sequences(mesh: Mesh, tree, axis_name: str = "dp"):
    """This rank's ``S / dp`` rows of every ``(S, ...)`` tensor of a pytree."""
    return _tree_map(lambda x: x[_rows(mesh, axis_name, x.shape[0])], tree)


def replicate(mesh: Mesh, tree):
    """The tensors as they are: every rank holds them whole."""
    return tree


def register_sequences_sharded(
    mesh: Mesh,
    model,
    cfg,
    step_params_batch,
    anchor_params_batch,
    init,
    frames: torch.Tensor,
    masks: torch.Tensor | None = None,
    axis_name: str = "dp",
):
    """Data-parallel batched registration: each dp rank registers its
    ``S / dp`` sequences with ``register_sequences_batched``; the fields of
    the result are assembled across dp, so every rank returns all ``S``."""
    from ..registration.pipeline import SequenceResult, register_sequences_batched

    S = frames.shape[0]
    local = register_sequences_batched(
        model, cfg,
        shard_sequences(mesh, step_params_batch, axis_name),
        shard_sequences(mesh, anchor_params_batch, axis_name),
        replicate(mesh, init),
        shard_sequences(mesh, frames, axis_name),
        None if masks is None else shard_sequences(mesh, masks, axis_name),
    )
    return SequenceResult(*(_assemble(mesh, axis_name, f, S) for f in local))


# ---------------------------------------------------------------------------
# The collective Chamfer

def _shard_rows(m: int, k: int, i: int) -> slice:
    """Rank ``i``'s rows of ``m`` split over ``k`` ranks: ``ceil(m / k)`` a
    rank, the last ones shorter (possibly empty)."""
    c = -(-m // k)
    return slice(min(i * c, m), min((i + 1) * c, m))


def sharded_search(mesh: Mesh, xs: torch.Tensor, ys: torch.Tensor, norm: int = 1,
                   axis_name: str = "sp"):
    """``nn_search_bidirectional(xs, ys)`` with the rows of ``ys`` split over
    the ranks of ``axis_name``: each rank runs the search kernel on its rows,
    and the result is assembled, equal to the unsharded search's, index for
    index, on every rank.

    x -> y: one all-reduce MIN of ``(distance bits << 32) | global index``
    (distances are never negative, so their bits order as they do) gives
    the global minimum and, among ranks that tie, the lowest index: the
    single-device first-index rule.  y -> x: each rank's rows of ``(dy,
    iy)``, assembled by one all-reduce SUM of zero buffers (float64: exact
    for both).  Takes ``(S, N, 3)``/``(S, M, 3)``.

    The three steps are functions of their own, :func:`search_local` ->
    :func:`search_reduce` -> :func:`search_unpack`, so that a caller can run
    the first and the last on the device as programs and the collectives
    between them (``train_step_dp_sp``)."""
    key, yside = search_local(mesh, xs, ys, norm, axis_name)
    return search_unpack(*search_reduce(mesh, key, yside, axis_name))


def search_local(mesh: Mesh, xs: torch.Tensor, ys: torch.Tensor, norm: int = 1,
                 axis_name: str = "sp") -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's part of :func:`sharded_search`, packed for the
    collectives: ``key (S, N)`` int64, the x -> y matches against the rank's
    rows of ``ys`` (int64 max where it has none), and ``yside (2, S, M)``
    float64, the y -> x distances and indices in the rank's rows, zeros
    elsewhere.  Waits on nothing on the host."""
    from ..ops.knn import nn_search_bidirectional

    S, n, m = xs.shape[0], xs.shape[1], ys.shape[1]
    rows = _shard_rows(m, mesh.shape[axis_name], mesh.index(axis_name))
    key = torch.full((S, n), torch.iinfo(torch.int64).max, dtype=torch.int64, device=xs.device)
    yside = torch.zeros((2, S, m), dtype=torch.float64, device=xs.device)
    if rows.stop > rows.start:
        dx, ix, dy, iy = nn_search_bidirectional(xs, ys[:, rows], norm)
        key = (dx.view(torch.int32).to(torch.int64) << 32) | (ix + rows.start)
        yside[0, :, rows] = dy.to(torch.float64)
        yside[1, :, rows] = iy.to(torch.float64)
    return key, yside


def search_reduce(mesh: Mesh, key: torch.Tensor, yside: torch.Tensor,
                  axis_name: str = "sp") -> tuple[torch.Tensor, torch.Tensor]:
    """The collectives of :func:`sharded_search`, in place: all-reduce MIN of
    ``key`` and SUM of ``yside`` over the ranks of ``axis_name``."""
    all_reduce(mesh, axis_name, key, "min")
    all_reduce(mesh, axis_name, yside)
    return key, yside


def search_unpack(key: torch.Tensor, yside: torch.Tensor):
    """``(dx, ix, dy, iy)`` of the reduced ``key`` and ``yside``."""
    dx = (key >> 32).to(torch.int32).view(torch.float32)
    return dx, key & 0xFFFFFFFF, yside[0].to(torch.float32), yside[1].to(torch.int64)


class _GatherRows(torch.autograd.Function):
    """Every rank's equal-sized rows along dim 1, concatenated in axis order;
    the gradient of a rank's rows is its slice of the (replicated) whole."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        rows = t.shape[1]
        ctx.cut = slice(mesh.index(axis) * rows, (mesh.index(axis) + 1) * rows)
        return _assemble(mesh, axis, t.transpose(0, 1), mesh.shape[axis] * rows).transpose(0, 1)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.cut], None, None


def _batch(x, y, x_mask, y_mask):
    if x.dim() != y.dim() or x.dim() not in (2, 3):
        raise ValueError(f"expected (N, 3)/(M, 3) or (S, N, 3)/(S, M, 3), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dim() == 3:
        return x, y, x_mask, y_mask, False
    return x[None], y[None], *(None if t is None else t[None] for t in (x_mask, y_mask)), True


def _weights(t: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return torch.ones(t.shape[:2], dtype=torch.float32, device=t.device)
    return mask.to(torch.float32)


def _split_search_chamfer(x, y, xw, yw, mesh: Mesh, axis: str, norm: int) -> torch.Tensor:
    """``ops.chamfer``'s loss and gradients of ``(S, N, 3)`` against the whole
    ``(S, M, 3)``, its search split by :func:`sharded_search`: the one set
    of collective semantics behind both public forms."""
    from ..ops.chamfer import _ChamferFn

    def search(xs, ys, nrm):
        return sharded_search(mesh, xs, ys, nrm, axis)

    return _ChamferFn.apply(x, y, xw, yw, norm, search)


def sharded_chamfer(
    mesh: Mesh,
    x: torch.Tensor,
    y: torch.Tensor,
    x_mask: torch.Tensor | None = None,
    y_mask: torch.Tensor | None = None,
    axis_name: str = "sp",
    norm: int = 1,
) -> torch.Tensor:
    """Differentiable Chamfer with the target cloud's search split over the
    ranks of ``axis_name``.

    Every rank passes the same whole ``x (N, 3)`` and ``y (M, 3)`` (or
    sequence batches ``(S, N, 3)``/``(S, M, 3)``, one loss per sequence, as
    ``ops.chamfer.chamfer_distance`` takes them), with the same masks (bool
    or float).  Each rank searches its ``ceil(M / sp)`` rows of ``y`` (the
    last rank's rows are fewer: no padding rows, which a masked ``x`` point,
    itself at the sentinel, could match) and :func:`sharded_search`
    assembles the matches; every rank then rebuilds the loss and, in the
    backward, the whole gradients of ``x`` and ``y`` from them as
    ``chamfer_distance`` does.  All ranks return that function's result on
    the unsharded clouds, bit for bit."""
    x, y, xm, ym, squeeze = _batch(x, y, x_mask, y_mask)
    loss = _split_search_chamfer(x, y, _weights(x, xm), _weights(y, ym), mesh, axis_name, norm)
    return loss[0] if squeeze else loss


def chamfer_collective(
    x_full: torch.Tensor,    # (N, 3) or (S, N, 3), whole on every rank of the axis
    y_shard: torch.Tensor,   # (Ms, 3) or (S, Ms, 3), this rank's target rows
    x_weight: torch.Tensor,  # (N,) or (S, N), whole
    y_weight: torch.Tensor,  # (Ms,) or (S, Ms), this rank's rows
    mesh: Mesh,
    axis_name: str = "sp",
    norm: int = 1,
) -> torch.Tensor:
    """Per-rank Chamfer body with ``axis_name`` collectives: the loss of
    ``x_full`` against the target whose equal-sized row slices the ranks of
    the axis hold (zero-weight points take no part).

    The target's rows and weights are assembled (exact), and the loss is
    :func:`sharded_chamfer`'s: the search split by :func:`sharded_search`,
    the loss and gradients rebuilt by every rank as ``ops.chamfer`` does.
    The gradient of ``x_full`` is whole on every rank; that of ``y_shard``
    is this rank's slice of the target's."""
    x, y, xw, yw, squeeze = _batch(x_full, y_shard, x_weight, y_weight)
    y = _GatherRows.apply(y, mesh, axis_name)
    yw = _assemble(mesh, axis_name, yw.to(torch.float32).transpose(0, 1),
                   y.shape[1]).transpose(0, 1)
    loss = _split_search_chamfer(x, y, xw.to(torch.float32), yw, mesh, axis_name, norm)
    return loss[0] if squeeze else loss


# train_epochs' defaults (stop patience, scheduler patience and factor), which
# the training step keeps
_TRAIN_SCHEDULE = (200, 5, 0.7)


def train_step_dp_sp(
    mesh: Mesh,
    model,
    params_batch: dict[str, torch.Tensor],  # (S, ...) pose-MLP state dict
    matrices_batch: torch.Tensor,  # (S, K, 4, 4)
    targets: torch.Tensor,         # (S, M, 3)
    points_batch: torch.Tensor,    # (S, N, 3) local cluster points
    labels_batch: torch.Tensor,    # (S, N)
    num_epochs: int = 10,
    lr: float = 2e-4,
    eager: bool = False,
):
    """One full training phase on a ``(dp, sp)`` mesh.

    Sequences split over dp; each sequence's Chamfer search splits its
    target over sp, the loss and its gradient assembled by the collectives
    that :func:`sharded_chamfer` and :func:`chamfer_collective` share (every
    rank holds the targets whole, so none is reassembled).  The optimizer
    is the production one (Adam, plateau scheduler, best tracking).
    Requires ``S % dp == 0`` and ``M % sp == 0``.  Returns
    ``(best_matrices (S, K, 4, 4), best_losses (S,))``, whole on every rank.

    The phase runs as programs (``utils/programs.py``): ``train_init``, then
    every epoch program A (the pose MLP and the rank's search,
    :func:`search_local`), the two all-reduces on the host
    (:func:`search_reduce`: a gloo collective waits on the host and cannot be
    captured) and program B (:func:`search_unpack` and the epoch,
    ``registration.optimizer.epoch_from_search``, which runs the MLP again
    for its gradient).  ``eager=True`` runs ``train_init`` + ``train_epochs``
    with the split Chamfer as its ``chamfer_fn``, the plain loop that the
    programs equal bit for bit.
    """
    from ..registration.optimizer import train_epochs, train_init

    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    S, M = targets.shape[0], targets.shape[1]
    if S % dp or M % sp:
        raise ValueError(f"need S % dp == 0 and M % sp == 0, got S={S} dp={dp} M={M} sp={sp}")
    rows = _rows(mesh, "dp", S)
    mats, pts, tgt, lab = (t[rows] for t in (matrices_batch, points_batch, targets, labels_batch))
    theta = model.flat_params(shard_sequences(mesh, params_batch, "dp"))
    if eager:
        xw = torch.ones(pts.shape[:2], dtype=torch.float32, device=pts.device)
        yw = torch.ones(tgt.shape[:2], dtype=torch.float32, device=pts.device)

        def cham(pred, y, pm, tm):
            return _split_search_chamfer(pred, y, xw, yw, mesh, "sp", 1)

        carry = train_init(theta, mats, lr)
        carry, _ = train_epochs(model, carry, mats, tgt, pts, lab, num_epochs,
                                None, None, *_TRAIN_SCHEDULE, chamfer_fn=cham)
    else:
        carry = _train_programs(mesh, model, theta, mats, tgt, pts, lab, num_epochs, lr)
    return _assemble(mesh, "dp", carry.best_m, S), _assemble(mesh, "dp", carry.best_loss, S)


def _train_programs(mesh: Mesh, model, theta, mats, tgt, pts, lab, num_epochs: int, lr: float):
    """``train_step_dp_sp``'s epochs as programs A and B around the
    collectives; returns the last carry."""
    from ..registration.optimizer import epoch_from_search, predict_points, train_init
    from ..utils import programs

    def search(theta, m, p, l, y):
        with torch.no_grad():
            _, pred = predict_points(model, theta, m, p, l)
            return search_local(mesh, pred, y, 1, "sp")

    def epoch(c, key, yside, m, p, l, y):
        return epoch_from_search(model, c, m, y, p, l, search_unpack(key, yside),
                                 *_TRAIN_SCHEDULE)

    # the search program closes over this rank's rows of the target: ranks
    # with other rows make other programs
    cut = _shard_rows(tgt.shape[1], mesh.shape["sp"], mesh.index("sp"))
    tag = (model.mode, model.hidden_dim, *_TRAIN_SCHEDULE, cut.start, cut.stop)
    carry = programs.run(("train_init", lr), lambda th, m: train_init(th, m, lr), theta, mats)
    for _ in range(num_epochs):
        key, yside = programs.run(("dp_sp_search", *tag), search, carry.theta, mats, pts, lab,
                                  tgt)
        # reduced in place in A's output buffers: B copies them into its own
        # inputs before A's next call overwrites them
        search_reduce(mesh, key, yside, "sp")
        carry, _ = programs.run(("dp_sp_epoch", *tag), epoch, carry, key, yside, mats, pts, lab,
                                tgt)
    return programs.clone(carry)
