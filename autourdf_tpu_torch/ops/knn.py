"""Nearest-neighbour search over point clouds: CUDA kernels + plain PyTorch.

Port of autourdf_tpu.ops.knn: the one-directional search (ICP
correspondences, the carry test), the bidirectional search with indices
(per-tile and accumulator kernels, chosen by size) and the min-only
bidirectional search.  Every function takes one cloud pair ``x (N, 3)``, ``y (M, 3)`` or a
batch ``x (S, N, 3)``, ``y (S, M, 3)``, fp32; ``norm=1`` is the
L1 distance, ``norm=2`` the squared L2 distance; ties resolve to the first
index, as ``jnp.argmin`` does.

On CUDA tensors each wrapper launches its hand-written kernel
(``csrc/knn.cu``) or raises; on CPU tensors it runs the plain version
beside it.  There is no other fallback.  The TPU VMEM predicates of the JAX
module (``VMEM_BUDGET``, ``_bidir_vmem_ok``, ...) describe TPU memory and
have no counterpart: the GPU kernel serves every cloud size.

The search is not differentiable (argmin indices); ops/chamfer.py rebuilds
the differentiable loss by gathering the matched neighbours.
"""

from __future__ import annotations

from typing import Literal

import torch

from . import _cuda

Norm = Literal[1, 2]

# Sentinel coordinate for masked/padded points: far from any real data,
# small enough that squared distances stay well inside f32 range.
PAD_COORD = 1e6

# Kernel launch counts, one per wrapper: each adds one where it launches its
# kernel and nowhere else, so a run can show the main path went through it.
launch_counts = {"nn_bidir": 0, "nn_min_bidir": 0, "nn": 0, "nn_bidir_acc": 0}

# nn_search_bidirectional takes the accumulator kernel when the per-tile
# kernel's (S, tiles, M) column scratch (8 bytes an entry) would exceed this
# many bytes.  On an H100 the accumulator was the faster of the two at both
# shapes timed (device time 0.089 against 0.118 ms at S=5, N=M=4,988 with
# 31 MB of scratch; 0.236 against 0.378 ms at S=1, N=M=20,000 with 100 MB;
# chip_smoke.py, PERF.md), so everything above the production shape of the
# registration goes to it.  That shape itself (5 sequences of up to 5,000
# points, 31.4 MB) stays on the per-tile kernel: there the search is 1% of a
# host-bound epoch, and moving the main path is left to a change that
# measures it end to end.
ACC_SCRATCH_BYTES = 32 * 1024 * 1024


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _batched(x: torch.Tensor, y: torch.Tensor):
    if x.dim() != y.dim() or x.dim() not in (2, 3) or x.shape[-1] != 3 or y.shape[-1] != 3:
        raise ValueError(f"expected (N, 3)/(M, 3) or (S, N, 3)/(S, M, 3), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dim() == 3 and x.shape[0] != y.shape[0]:
        raise ValueError(f"sequence batch mismatch: {x.shape[0]} vs {y.shape[0]}")
    if x.shape[-2] == 0 or y.shape[-2] == 0:
        raise ValueError("empty point cloud")
    if x.device != y.device:
        raise ValueError(f"x on {x.device}, y on {y.device}")
    squeeze = x.dim() == 2
    return (x[None], y[None], squeeze) if squeeze else (x, y, squeeze)


def _check_cuda(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"CUDA kernels take float32, got {x.dtype} and {y.dtype}")
    return x.contiguous(), y.contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the _nn_xla counterpart, chunked at 1024 rows.
# The distance is written as explicit elementwise operations in the kernel's
# order, so on the same inputs both give bit-identical distances.
# ---------------------------------------------------------------------------

def _pair_dist(x: torch.Tensor, y: torch.Tensor, norm: int) -> torch.Tensor:
    """(S, n, 3), (S, m, 3) -> (S, n, m) distances, summed left to right."""
    d0 = x[:, :, None, 0] - y[:, None, :, 0]
    d1 = x[:, :, None, 1] - y[:, None, :, 1]
    d2 = x[:, :, None, 2] - y[:, None, :, 2]
    if norm == 1:
        return d0.abs() + d1.abs() + d2.abs()
    return d0 * d0 + d1 * d1 + d2 * d2


def _nn_plain(x: torch.Tensor, y: torch.Tensor, norm: int, chunk: int = 1024):
    """x -> y (min, first argmin) for a batch, 1024 query rows at a time."""
    ds, idx = [], []
    for a in range(0, x.shape[1], chunk):
        d = _pair_dist(x[:, a:a + chunk], y, norm)
        ds.append(d.amin(-1))
        idx.append(torch.argmin(d, dim=-1))
    return torch.cat(ds, 1), torch.cat(idx, 1)


def _nn_bidir_plain(x, y, norm: int):
    dx, ix = _nn_plain(x, y, norm)
    dy, iy = _nn_plain(y, x, norm)
    return dx, ix, dy, iy


def _nn_min_bidir_plain(x, y, norm: int, chunk: int = 1024):
    dxs, dy = [], None
    for a in range(0, x.shape[1], chunk):
        d = _pair_dist(x[:, a:a + chunk], y, norm)
        dxs.append(d.amin(-1))
        col = d.amin(-2)
        dy = col if dy is None else torch.minimum(dy, col)
    return torch.cat(dxs, 1), dy


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _nn_bidir_cuda(x, y, norm: int):
    """Replaces _nn_bidir_kernel (autourdf_tpu/ops/knn.py:149).  Bound on the
    H100 by fp32 ALU work (~9 ops per pair over S*N*M pairs) plus the
    (S, tiles, M) column-partial traffic; see csrc/knn.cu for the design."""
    x, y = _check_cuda(x, y)
    lib = _cuda.library("knn")
    S, N, M = x.shape[0], x.shape[1], y.shape[1]
    tiles = -(-N // lib.knn_tile_rows())
    dx = torch.empty((S, N), dtype=torch.float32, device=x.device)
    ix = torch.empty((S, N), dtype=torch.int64, device=x.device)
    cmin = torch.empty((S, tiles, M), dtype=torch.float32, device=x.device)
    carg = torch.empty((S, tiles, M), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.knn_bidir_launch(x.data_ptr(), y.data_ptr(), S, N, M, norm,
                                   dx.data_ptr(), ix.data_ptr(), cmin.data_ptr(),
                                   carg.data_ptr(), _stream(x))
    _cuda.check(err, "knn_bidir_launch")
    launch_counts["nn_bidir"] += 1
    dy, iy = _fold_column_tiles(cmin, carg)
    return dx, ix, dy, iy


def _fold_column_tiles(cmin: torch.Tensor, carg: torch.Tensor):
    """Fold per-tile column partials ``(S, tiles, M)`` into the y -> x
    direction, first tile on ties (the TPU fold at knn.py:226-230)."""
    tile_pick = torch.argmin(cmin, dim=1, keepdim=True)     # (S, 1, M)
    dy = torch.gather(cmin, 1, tile_pick)[:, 0]
    iy = torch.gather(carg, 1, tile_pick)[:, 0].long()
    return dy, iy


def _nn_min_bidir_cuda(x, y, norm: int):
    """Replaces _nn_min_bidir_kernel (autourdf_tpu/ops/knn.py:313).  Bound on
    the H100 by fp32 ALU work (~9 ops per pair over S*N*M pairs); the column
    minima meet in one atomicMin per (block, column)."""
    x, y = _check_cuda(x, y)
    lib = _cuda.library("knn")
    S, N, M = x.shape[0], x.shape[1], y.shape[1]
    dx = torch.empty((S, N), dtype=torch.float32, device=x.device)
    cbits = torch.full((S, M), 0x7F800000, dtype=torch.int32, device=x.device)  # +inf
    with torch.cuda.device(x.device):
        err = lib.knn_min_bidir_launch(x.data_ptr(), y.data_ptr(), S, N, M, norm,
                                       dx.data_ptr(), cbits.data_ptr(), _stream(x))
    _cuda.check(err, "knn_min_bidir_launch")
    launch_counts["nn_min_bidir"] += 1
    return dx, cbits.view(torch.float32)


def _nn_cuda(x, y, norm: int):
    """Replaces _nn_kernel (autourdf_tpu/ops/knn.py:54).  Bound on the H100
    by fp32 ALU work (~8 ops per pair over S*N*M pairs); row results only,
    so no scratch and no traffic beyond inputs and outputs."""
    x, y = _check_cuda(x, y)
    lib = _cuda.library("knn")
    S, N, M = x.shape[0], x.shape[1], y.shape[1]
    dx = torch.empty((S, N), dtype=torch.float32, device=x.device)
    ix = torch.empty((S, N), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.knn_nn_launch(x.data_ptr(), y.data_ptr(), S, N, M, norm,
                                dx.data_ptr(), ix.data_ptr(), _stream(x))
    _cuda.check(err, "knn_nn_launch")
    launch_counts["nn"] += 1
    return dx, ix


# (bits of +inf) << 32 | INT_MAX: above every (distance, row) word
_ACC_INIT = (0x7F800000 << 32) | 0x7FFFFFFF


def _nn_bidir_acc_cuda(x, y, norm: int):
    """Replaces _nn_bidir_acc_kernel (autourdf_tpu/ops/knn.py:233).  Bound on
    the H100 by fp32 ALU work (~9 ops per pair); the column (min, argmin)
    meet in one 64-bit atomicMin word per y point instead of the per-tile
    kernel's (S, tiles, M) scratch."""
    x, y = _check_cuda(x, y)
    lib = _cuda.library("knn")
    S, N, M = x.shape[0], x.shape[1], y.shape[1]
    dx = torch.empty((S, N), dtype=torch.float32, device=x.device)
    ix = torch.empty((S, N), dtype=torch.int64, device=x.device)
    packed = torch.full((S, M), _ACC_INIT, dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.knn_bidir_acc_launch(x.data_ptr(), y.data_ptr(), S, N, M, norm,
                                       dx.data_ptr(), ix.data_ptr(), packed.data_ptr(),
                                       _stream(x))
    _cuda.check(err, "knn_bidir_acc_launch")
    launch_counts["nn_bidir_acc"] += 1
    dy, iy = _unpack_columns(packed)
    return dx, ix, dy, iy


def _unpack_columns(packed: torch.Tensor):
    """(S, M) int64 words, distance bits high and x row low -> (dy, iy)."""
    dy = (packed >> 32).to(torch.int32).view(torch.float32)
    iy = packed & 0xFFFFFFFF
    return dy, iy


def _nn_bidir_auto_cuda(x, y, norm: int):
    """The per-tile kernel while its column scratch is small, the
    accumulator kernel above ACC_SCRATCH_BYTES (the counterpart of the
    _bidir_vmem_ok dispatch at autourdf_tpu/ops/knn.py:429-444)."""
    tiles = -(-x.shape[1] // _cuda.library("knn").knn_tile_rows())
    if x.shape[0] * tiles * y.shape[1] * 8 > ACC_SCRATCH_BYTES:
        return _nn_bidir_acc_cuda(x, y, norm)
    return _nn_bidir_cuda(x, y, norm)


def _dispatch(x, y, norm, cuda_fn, plain_fn):
    if norm not in (1, 2):
        raise ValueError(f"norm must be 1 or 2, got {norm}")
    xb, yb, squeeze = _batched(x, y)
    if xb.is_cuda:
        out = cuda_fn(xb, yb, norm)
    elif xb.device.type == "cpu":
        out = plain_fn(xb, yb, norm)
    else:
        raise ValueError(f"unsupported device {xb.device}")
    return tuple(o[0] for o in out) if squeeze else out


def nn_search_bidirectional(
    x: torch.Tensor, y: torch.Tensor, norm: Norm = 1
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both nearest-neighbour directions from one pass: ``(dx, ix, dy, iy)``.

    ``dx, ix`` are x -> y (min distance and int64 index into y), ``dy, iy``
    are y -> x.  Every pairwise distance is computed once.
    """
    return _dispatch(x, y, norm, _nn_bidir_auto_cuda, _nn_bidir_plain)


def nn_min_bidirectional(
    x: torch.Tensor, y: torch.Tensor, norm: Norm = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Min distances in both directions, no argmin: ``(dx, dy)``.

    The forward-only Chamfer primitive: the same distance math as
    :func:`nn_search_bidirectional` without the index bookkeeping.
    """
    return _dispatch(x, y, norm, _nn_min_bidir_cuda, _nn_min_bidir_plain)


def nn_search(x: torch.Tensor, y: torch.Tensor, norm: Norm = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """For each point of ``x``, the nearest point of ``y``: ``(dist, idx)``.

    ``dist`` is the L1 distance (norm=1) or the squared L2 distance
    (norm=2), ``idx`` int64 into ``y``.  Sentinel ``y`` points (coordinate
    ``PAD_COORD``) are never selected while one real point exists; with none
    the result is index 0 at a finite distance.  Not differentiable; gather
    ``y[idx]`` for gradients.
    """
    return _dispatch(x, y, norm, _nn_cuda, _nn_plain)
