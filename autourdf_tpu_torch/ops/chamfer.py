"""Differentiable Chamfer distance (port of autourdf_tpu.ops.chamfer).

    loss = mean_i min_j d(x_i, y_j) + mean_j min_i d(y_j, x_i)

with d the L1 distance for norm=1 and the *squared* L2 distance for norm=2
(pytorch3d ``chamfer_distance`` semantics).  Every function takes one
cloud pair ``(N, 3)``/``(M, 3)`` or a sequence batch ``(S, N, 3)``/
``(S, M, 3)`` and then returns one loss per sequence.

Masks make padded points contribute zero and weight the means by true
counts; masked points move to the ``PAD_COORD`` sentinel before the search
so they are never matched.

The gradient is a ``torch.autograd.Function``: the forward runs the indexed
bidirectional search, the backward is the gather plus scatter-add
rebuild of ``_chamfer_cvjp_bwd`` — exactly the subgradient of the true
Chamfer objective (the argmin is piecewise constant).  A call that needs no
gradient runs the min-only kernel instead, as the JAX custom-VJP primal
does.

Inside ``parallel.mesh_scope(mesh)`` with an ``sp`` axis larger than 1,
targets of at least ``AUTO_SHARD_MIN_M`` points go to
``parallel.sharding.sharded_chamfer``.
"""

from __future__ import annotations

import os

import torch

from .knn import PAD_COORD, Norm, nn_min_bidirectional, nn_search, nn_search_bidirectional
from .reduce import row_sums


# Auto-shard threshold: the JAX package's value, so that both packages shard
# the same calls (AUTOURDF_AUTO_SHARD_MIN_M overrides it).
AUTO_SHARD_MIN_M = int(os.environ.get("AUTOURDF_AUTO_SHARD_MIN_M", 32768))


def _active_sp_mesh():
    """The active mesh (``parallel.mesh_scope``), if its sp axis is > 1."""
    from ..parallel.sharding import active_mesh

    mesh = active_mesh()
    if mesh is not None and mesh.shape.get("sp", 1) > 1:
        return mesh
    return None


def _pointwise(diff: torch.Tensor, norm: int) -> torch.Tensor:
    if norm == 1:
        # |d| with the subgradient +1 at d = 0 (coincident points), the choice
        # jnp.abs makes under autodiff; torch.abs would give 0 there
        return torch.sum(torch.where(diff >= 0, diff, -diff), dim=-1)
    return torch.sum(diff * diff, dim=-1)


def _masked_mean(vals: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return torch.mean(vals, dim=-1)
    m = mask.to(vals.dtype)
    return torch.sum(vals * m, dim=-1) / torch.clamp_min(torch.sum(m, dim=-1), 1.0)


def _weighted_mean(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-sequence weighted mean of ``(S, N)`` values, each sequence's
    sums independent of the others in the batch (``ops/reduce.py``)."""
    num, den = row_sums(torch.stack([vals * w, w]))
    return num / torch.clamp_min(den, 1.0)


def _apply_mask(pts: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Move masked-out points to the far sentinel so they are never matched."""
    if mask is None:
        return pts
    return torch.where(mask[..., None] > 0, pts, PAD_COORD)


def _gather_points(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pts[idx]`` per batch element: (..., M, 3), (..., N) -> (..., N, 3)."""
    return torch.gather(pts, -2, idx[..., None].expand(idx.shape + (3,)))


def _scatter_add_points(like: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``zeros_like(like).at[idx].add(vals)`` per batch element.

    ``index_put_`` with ``accumulate=True`` sorts the indices and sums each
    target's values in their order, on the card as on the CPU, so the sums
    are the same every run (``index_add_`` on the card adds with float
    atomics in arrival order, and a registration would vary run to run)."""
    S, n = like.shape[0], like.shape[1]
    offs = torch.arange(S, device=idx.device)[:, None] * n
    out = torch.zeros((S * n, 3), dtype=like.dtype, device=like.device)
    out.index_put_(((idx + offs).reshape(-1),), vals.reshape(-1, 3), accumulate=True)
    return out.view(S, n, 3)


class _ChamferFn(torch.autograd.Function):
    """Batched Chamfer with the gather + scatter-add backward (S, N, 3).
    ``search`` gives the bidirectional search's ``(dx, ix, dy, iy)``
    (``parallel.sharding`` passes one that splits it over ranks)."""

    @staticmethod
    def forward(ctx, x, y, xm, ym, norm, search):
        dx, ix, dy, iy = search(_apply_mask(x, xm), _apply_mask(y, ym), norm)
        ctx.save_for_backward(x, y, ix, iy, xm, ym)
        ctx.norm = norm
        return _weighted_mean(dx, xm) + _weighted_mean(dy, ym)

    @staticmethod
    def backward(ctx, g):
        x, y, ix, iy, xm, ym = ctx.saved_tensors
        nv = torch.clamp_min(torch.sum(xm, dim=-1), 1.0)
        mv = torch.clamp_min(torch.sum(ym, dim=-1), 1.0)
        diff_x = x - _gather_points(y, ix)          # (S, N, 3) matched x -> y
        diff_y = y - _gather_points(x, iy)          # (S, M, 3) matched y -> x
        if ctx.norm == 1:
            phi_x, phi_y = torch.sign(diff_x), torch.sign(diff_y)
        else:
            phi_x, phi_y = 2.0 * diff_x, 2.0 * diff_y
        wx = (g / nv)[:, None, None] * xm[..., None]
        wy = (g / mv)[:, None, None] * ym[..., None]
        # a side that needs no gradient (the frames of a fit) costs nothing
        grad_x = grad_y = None
        if ctx.needs_input_grad[0]:
            grad_x = wx * phi_x + _scatter_add_points(x, iy, -wy * phi_y)
        if ctx.needs_input_grad[1]:
            grad_y = wy * phi_y + _scatter_add_points(y, ix, -wx * phi_x)
        return grad_x, grad_y, None, None, None, None


def chamfer_distance(
    x: torch.Tensor,
    y: torch.Tensor,
    x_mask: torch.Tensor | None = None,
    y_mask: torch.Tensor | None = None,
    norm: Norm = 1,
) -> torch.Tensor:
    """Symmetric Chamfer loss between ``x`` and ``y`` (one per sequence).

    With autograd recording and an input that requires grad, the indexed
    bidirectional kernel runs and the backward rebuilds the subgradient;
    otherwise the min-only kernel gives the loss straight from its
    min-distance outputs.  Inside ``parallel.mesh_scope(mesh)`` (sp > 1),
    targets of ``AUTO_SHARD_MIN_M`` points or more shard over the sp ranks.
    """
    if y.shape[-2] >= AUTO_SHARD_MIN_M:
        mesh = _active_sp_mesh()
        if mesh is not None:
            from ..parallel.sharding import sharded_chamfer

            return sharded_chamfer(mesh, x, y, x_mask, y_mask, norm=norm)
    squeeze = x.dim() == 2
    if squeeze:
        x, y, x_mask, y_mask = (None if t is None else t[None] for t in (x, y, x_mask, y_mask))
    S, n, m = x.shape[0], x.shape[1], y.shape[1]
    xm = (torch.ones((S, n), dtype=torch.float32, device=x.device) if x_mask is None
          else x_mask.to(torch.float32))
    ym = (torch.ones((S, m), dtype=torch.float32, device=y.device) if y_mask is None
          else y_mask.to(torch.float32))
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        loss = _ChamferFn.apply(x, y, xm, ym, norm, nn_search_bidirectional)
    else:
        dx, dy = nn_min_bidirectional(_apply_mask(x, xm), _apply_mask(y, ym), norm)
        loss = _weighted_mean(dx, xm) + _weighted_mean(dy, ym)
    return loss[0] if squeeze else loss


def chamfer_correspondences(
    x: torch.Tensor,
    y: torch.Tensor,
    x_mask: torch.Tensor | None = None,
    y_mask: torch.Tensor | None = None,
    norm: Norm = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-neighbour index pair ``(ix, iy)`` for the symmetric Chamfer.

    One fused kernel pass; not differentiable.  Feed the result to
    :func:`chamfer_from_indices` to refresh correspondences every k
    optimizer epochs instead of every epoch (ICP-style amortization).
    """
    with torch.no_grad():
        xs = _apply_mask(x.detach(), x_mask)
        ys = _apply_mask(y.detach(), y_mask)
        _, ix, _, iy = nn_search_bidirectional(xs, ys, norm)
    return ix, iy


def chamfer_from_indices(
    x: torch.Tensor,
    y: torch.Tensor,
    ix: torch.Tensor,
    iy: torch.Tensor,
    x_mask: torch.Tensor | None = None,
    y_mask: torch.Tensor | None = None,
    norm: Norm = 1,
) -> torch.Tensor:
    """Differentiable Chamfer value for fixed correspondences.

    With fresh ``(ix, iy)`` this equals :func:`chamfer_distance`; with stale
    indices it upper-bounds it (projected/ICP-style objective).
    """
    d_xy = _pointwise(x - _gather_points(y, ix), norm)
    d_yx = _pointwise(y - _gather_points(x, iy), norm)
    return _masked_mean(d_xy, x_mask) + _masked_mean(d_yx, y_mask)


def _masked_quantile(vals: torch.Tensor, mask: torch.Tensor | None, q: float) -> torch.Tensor:
    """q-quantile of ``vals`` along the last axis restricted to ``mask``
    (nearest-rank)."""
    n = vals.shape[-1]
    if mask is None:
        return torch.sort(vals, dim=-1).values[..., int(q * (n - 1))]
    valid = mask > 0
    s = torch.sort(torch.where(valid, vals, torch.inf), dim=-1).values
    cnt = torch.sum(valid, dim=-1)
    idx = torch.clamp((q * (cnt - 1)).to(torch.int32), 0, n - 1).long()
    return torch.gather(s, -1, idx[..., None])[..., 0]


def chamfer_distance_trunc(
    x: torch.Tensor,
    y: torch.Tensor,
    x_mask: torch.Tensor | None = None,
    y_mask: torch.Tensor | None = None,
    norm: Norm = 1,
    mult: float = 5.0,
    q: float = 0.5,
) -> torch.Tensor:
    """Truncated (robust) symmetric Chamfer: per-point min distances are
    clipped at ``tau = mult * quantile_q`` of that direction's matched
    distances before the mean.

    Wrong matches of occlusion-incomplete clouds live in the far tail of
    the matched-distance distribution, so clipping at a few times the
    median removes their gradient and leaves true-surface gradients
    untouched.  ``tau`` carries no gradient: ``minimum(d, tau)`` then gives
    the exact subgradient of the truncated objective.  Reduces to
    :func:`chamfer_distance` as ``mult -> inf``.  One indexed search plus
    the gather rebuild.
    """
    ix, iy = chamfer_correspondences(x, y, x_mask, y_mask, norm)
    d_xy = _pointwise(x - _gather_points(y, ix), norm)
    d_yx = _pointwise(y - _gather_points(x, iy), norm)
    tau_x = (mult * _masked_quantile(d_xy, x_mask, q)).detach()
    tau_y = (mult * _masked_quantile(d_yx, y_mask, q)).detach()
    return (_masked_mean(torch.minimum(d_xy, tau_x[..., None]), x_mask)
            + _masked_mean(torch.minimum(d_yx, tau_y[..., None]), y_mask))


def chamfer_directional(
    x: torch.Tensor,
    y: torch.Tensor,
    x_mask: torch.Tensor | None = None,
    y_mask: torch.Tensor | None = None,
    norm: Norm = 1,
) -> torch.Tensor:
    """One-directional term ``mean_i min_j d(x_i, y_j)`` (x -> y only); the
    gradient flows through the gathered neighbours."""
    with torch.no_grad():
        _, ix = nn_search(_apply_mask(x.detach(), x_mask), _apply_mask(y.detach(), y_mask), norm)
    return _masked_mean(_pointwise(x - _gather_points(y, ix), norm), x_mask)
