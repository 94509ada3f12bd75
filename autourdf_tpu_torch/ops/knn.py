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

import functools
from dataclasses import dataclass
from typing import Literal

import torch

from . import _cuda

Norm = Literal[1, 2]

# Sentinel coordinate for masked/padded points: far from any real data,
# small enough that squared distances stay well inside f32 range.
PAD_COORD = 1e6

# Block constants of the sweeps in csrc/knn.cu (bidir_sweep behind the two
# indexed bidirectional kernels, light_sweep behind nn_kernel and
# nn_min_bidir_kernel), mirrored here so that the planning below runs without
# the library: rows come in register sub-tiles of SWEEP_SUB_ROWS, the column
# side of bidir_sweep groups SWEEP_GROUP_ROWS rows, a thread holds
# SWEEP_GROUP_COLS columns, a block runs at most SWEEP_MAX_THREADS threads at
# 128 registers each and may opt into SHARED_LIMIT bytes of dynamic shared
# memory.  The library gives its own values (knn_sweep_constant);
# tests/test_torch_cuda.py holds these to them on the card.
SWEEP_SUB_ROWS = 32
SWEEP_GROUP_ROWS = 4
SWEEP_GROUP_COLS = 4
SWEEP_MAX_THREADS = 512
SHARED_LIMIT = 232_448
# An SM has 228 KB of shared memory, of which every resident block reserves
# 1 KB, and 65,536 registers: 512 resident threads of a sweep.
_SM_SHARED_BYTES = 233_472
_BLOCK_RESERVED_BYTES = 1024
_SM_RESIDENT_THREADS = 512
# The accumulator kernel cuts y into chunks of at most this many columns
# (8 bytes of shared memory a column), so four blocks stay resident per SM
# whatever M is.  Chunks of 2,500 columns were the fastest of 2,500, 5,000
# and 10,000 at S=1, N=M=20,000 (0.168, 0.171 and 0.177 ms of kernel time at
# their best rows and threads; H100 80GB HBM3, 700 W,
# scripts/torch_knn_tune.py).
ACC_CHUNK_COLS = 2560
# The min-only kernel keeps 4 bytes of shared memory a column and cuts y
# only so that every M is taken: chunks of at most this many columns (40 KB).
# Not tuned: no path runs the min-only search above 5,000 points.
MIN_CHUNK_COLS = 10240
# Planning weights: the fixed work of a block (loading its rows, the column
# flush) costs about as much as _FLUSH_ROWS more rows, and an SM needs
# _SATURATING_WARPS resident warps to keep its schedulers busy (12 and 16
# warps an SM read the same time on the H100, 4 read 1.3 times as much;
# scripts/torch_knn_tune.py).
_FLUSH_ROWS = 2
_SATURATING_WARPS = 12
_SWEEP_THREADS = (128, 256, 512)
_SWEEP_MAX_ROWS = 256
# light_sweep (nn_kernel, nn_min_bidir_kernel).  The row fold of an nn_kernel
# sub-tile (two REDUX a row, the meeting of the warps, the deferred argmin)
# costs a thread about as much as _NN_FOLD_PAIRS distances (the min-only
# kernel's fold did not show in the sweeps); the min-only kernel's column
# flush costs as much as _FLUSH_ROWS more rows.  Blocks go down to one warp;
# blocks of 512 threads are not tried (16 warps waiting on one barrier a
# sub-tile: 1.3 to 2 times the time of 128 threads at every shape swept), nor
# nn_kernel blocks above 64 rows (nothing to amortise without a column side:
# 32 and 64 rows were the fastest at every shape and thread count, 128 to 512
# rows 4 to 27% slower at S=100, N=M=4,988).  H100 80GB HBM3, 700 W,
# scripts/torch_knn_tune.py.
_NN_FOLD_PAIRS = 48
_LIGHT_THREADS = (32, 64, 128, 256)
_LIGHT_MAX_ROWS = {"nn": 64, "nn_min_bidir": 512}
_INDEXED_KERNELS = ("nn_bidir", "nn_bidir_acc")
_LIGHT_KERNELS = ("nn", "nn_min_bidir")

# nn_search_bidirectional takes the per-tile kernel where it takes the shape
# and its (S, blocks, M) column scratch (8 bytes an entry) stays within this
# many bytes; everything else goes to the accumulator, which needs no
# scratch.  The threshold is not a tuned one: it is set between the
# registration's production shape (5 sequences of up to 5,000 points, 10.4 MB
# of scratch) and one 20,000-point pair (20 MB), so that large clouds keep
# running the accumulator and both kernels stay on a real path.  Device time
# alone would put it above 20 MB: the per-tile kernel's whole wrapper is ahead
# at both shapes (H100 80GB HBM3, 700 W, chip_smoke.py [3], per-tile /
# accumulator: 0.056 / 0.066 ms at S=5, N=M=4,988 and 0.156 / 0.168 ms at S=1,
# N=M=20,000), and its fold of 20 MB of partials was not measured slower for
# exceeding any cache budget.  What speaks for the accumulator at large M is
# evenness, not speed: there the per-tile kernel runs one 512-thread block an
# SM and its time swings with the grid (0.148 ms with 125 blocks on 132 SMs,
# 0.234 ms with 157; scripts/torch_knn_tune.py), where the accumulator's
# thousands of small blocks do not depend on how N divides by the SM count.
ACC_SCRATCH_BYTES = 16 * 1024 * 1024


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


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the _nn_xla counterpart, chunked at 1024 rows.
# The distance is written as explicit elementwise operations in the kernel's
# order, so on the same inputs both give bit-identical distances.
# ---------------------------------------------------------------------------

def _pair_dist(x: torch.Tensor, y: torch.Tensor, norm: int) -> torch.Tensor:
    """(S, n, 3), (S, m, 3) -> (S, n, m) distances, summed left to right
    (in place: one block and one scratch block of the result's size)."""
    d = x[:, :, None, 0] - y[:, None, :, 0]
    t = torch.empty_like(d)
    if norm == 1:
        d.abs_()
        for c in (1, 2):
            torch.sub(x[:, :, None, c], y[:, None, :, c], out=t)
            d += t.abs_()
    else:
        d.mul_(d)
        for c in (1, 2):
            torch.sub(x[:, :, None, c], y[:, None, :, c], out=t)
            d += t.mul_(t)
    return d


def _nn_plain(x: torch.Tensor, y: torch.Tensor, norm: int, chunk: int = 1024):
    """x -> y (min, first argmin) for a batch, 1024 query rows at a time."""
    ds, idx = [], []
    for a in range(0, x.shape[1], chunk):
        d = _pair_dist(x[:, a:a + chunk], y, norm)
        ds.append(d.amin(-1))
        idx.append(torch.argmin(d, dim=-1))
    return torch.cat(ds, 1), torch.cat(idx, 1)


def _nn_bidir_plain(x, y, norm: int, chunk: int = 1024):
    """Both directions from one distance block per chunk: |y - x| is |x - y|
    bit for bit, and a column's first argmin is kept across chunks (a later
    chunk takes over only where it is strictly smaller)."""
    dxs, ixs, dy, iy = [], [], None, None
    for a in range(0, x.shape[1], chunk):
        d = _pair_dist(x[:, a:a + chunk], y, norm)
        dxs.append(d.amin(-1))
        ixs.append(torch.argmin(d, dim=-1))
        col, ci = d.amin(-2), torch.argmin(d, dim=-2) + a
        if dy is None:
            dy, iy = col, ci
        else:
            take = col < dy
            dy, iy = torch.where(take, col, dy), torch.where(take, ci, iy)
    return torch.cat(dxs, 1), torch.cat(ixs, 1), dy, iy


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

@dataclass(frozen=True)
class SweepPlan:
    """How one launch of a search kernel cuts the work: a block owns
    ``rows`` x rows and ``cols`` y columns and runs ``threads`` threads."""
    kernel: str                     # "nn_bidir", "nn_bidir_acc", "nn" or "nn_min_bidir"
    rows: int
    cols: int
    threads: int
    grid: tuple[int, int, int]      # (row blocks, column chunks, S)
    shared_bytes: int               # dynamic shared memory of a block
    resident: int                   # blocks an SM can hold at once
    scratch_bytes: int              # partials (per-tile) or words (accumulator)
    sms: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def blocks_per_sm(self) -> float:
        return self.blocks / self.sms

    @property
    def waves(self) -> float:
        return self.blocks / (self.sms * self.resident)


def sweep_shared_bytes(rows: int, cols: int, threads: int) -> int:
    """Dynamic shared memory of a sweep block (csrc/knn.cu
    sweep_shared_bytes): the x rows, the cross-warp row fold and, when the
    block has more than one sub-tile, 8 bytes of column state per slot."""
    span = threads * SWEEP_GROUP_COLS
    slots = 0 if rows <= SWEEP_SUB_ROWS else -(-cols // span) * span
    return rows * 16 + (threads // 32) * SWEEP_SUB_ROWS * 8 + slots * 8


def light_shared_bytes(kernel: str, rows: int, cols: int, threads: int) -> int:
    """Dynamic shared memory of a light_sweep block (csrc/knn.cu
    light_shared_bytes): the x rows, two buffers of the cross-warp row fold
    (8 bytes a row and warp with indices, 4 without) and, in the min-only
    sweep of more than one sub-tile, 4 bytes of running column minimum per
    slot."""
    indexed = kernel == "nn"
    span = threads * SWEEP_GROUP_COLS
    slots = 0 if indexed or rows <= SWEEP_SUB_ROWS else -(-cols // span) * span
    return rows * 16 + 2 * (threads // 32) * SWEEP_SUB_ROWS * (8 if indexed else 4) + slots * 4


def _resident_blocks(shared_bytes: int, threads: int) -> int:
    return min(_SM_RESIDENT_THREADS // threads,
               _SM_SHARED_BYTES // (shared_bytes + _BLOCK_RESERVED_BYTES))


@functools.lru_cache(maxsize=256)
def plan_bidir(S: int, N: int, M: int, sms: int, kernel: str) -> SweepPlan | None:
    """Rows per block, columns per chunk and threads per block for one
    launch of ``kernel`` on a card with ``sms`` SMs; None when the per-tile
    kernel does not take the shape (its 8 * M bytes of column state do not
    fit a block).

    Candidates for the two indexed bidirectional kernels are the multiples of
    SWEEP_SUB_ROWS rows up to 256 at 128, 256 and 512 threads.  The busiest
    SM runs ceil(blocks / sms) blocks; a thread of a block computes (rows +
    _FLUSH_ROWS) x (column passes of its threads) x SWEEP_GROUP_COLS
    distances (a pass covers threads x SWEEP_GROUP_COLS columns, so a ragged
    last pass is paid in full), slowed where fewer than _SATURATING_WARPS
    warps are resident; the cheapest candidate wins, then the larger block
    (less scratch, fewer atomics), then fewer threads.  The weights are
    fitted to two swept shapes (S=5, N=M=4,988 and S=1, N=M=20,000), not
    derived.  Swept also at S=2, N=M=4,988 and at the ragged S=5, N=4,418,
    M=4,985, the plan's wrapper device time over the best swept is 1.00-1.01
    for the accumulator and 1.01, 1.00, 1.13 and 1.05 for the per-tile kernel
    (H100 80GB HBM3, 700 W, scripts/torch_knn_tune.py; PERF.md).

    Candidates for ``"nn"`` (32 or 64 rows) and ``"nn_min_bidir"`` (up to 512
    rows) run 32 to 256 threads.  A thread's work is counted the same way
    (``"nn"`` has no column flush but pays _NN_FOLD_PAIRS distances' worth
    for the row fold of every sub-tile); the busiest SM takes its blocks in
    rounds of as many as are resident, and a round costs its blocks' work,
    or what _SATURATING_WARPS warps would do in the time where it holds
    fewer: a last round of a few small blocks is paid as a tail.  Fitted to
    sweeps at S=100, N=M=4,988, at S=9, N=25,600, M=2,048 and at S=5,
    N=M=4,988, where the plan's device time over the best swept is at most
    1.01 for both kernels (same card and script; PERF.md).
    """
    cols = _chunk_cols(M, kernel)
    light = kernel in _LIGHT_KERNELS
    # a block always meets its column side over at least two sub-tiles (when
    # x has them), so neither the scratch nor the atomics fall back to one
    # partial per 32 rows
    first = 2 * SWEEP_SUB_ROWS if N > SWEEP_SUB_ROWS and kernel != "nn" else SWEEP_SUB_ROWS
    best = None
    for threads in (_LIGHT_THREADS if light else _SWEEP_THREADS):
        for rows in range(first, (_LIGHT_MAX_ROWS[kernel] if light else _SWEEP_MAX_ROWS) + 1,
                          SWEEP_SUB_ROWS):
            plan = make_plan(S, N, M, sms, kernel, rows, cols, threads)
            if plan is None:
                continue
            busiest = -(-plan.blocks // sms)
            warps = min(plan.resident, busiest) * threads // 32
            passes = -(-min(cols, M) // (threads * SWEEP_GROUP_COLS))
            live = min(rows, N)
            if kernel == "nn":
                pairs = (live * passes * SWEEP_GROUP_COLS
                         + -(-live // SWEEP_SUB_ROWS) * _NN_FOLD_PAIRS)
            else:
                pairs = (live + _FLUSH_ROWS) * passes * SWEEP_GROUP_COLS
            if light:
                full, rest = divmod(busiest, plan.resident)
                saturating = _SATURATING_WARPS * 32 / threads       # blocks
                cost = pairs * threads * (full * max(plan.resident, saturating)
                                          + (max(rest, saturating) if rest else 0))
            else:
                cost = busiest * pairs * threads * max(1.0, _SATURATING_WARPS / warps)
            key = (cost, -rows, threads)
            if best is None or key < best[0]:
                best = (key, plan)
            if rows >= N:
                break
    return None if best is None else best[1]


def _chunk_cols(M: int, kernel: str) -> int:
    """Columns of y a block takes: all of them in the per-tile kernel and in
    the one-directional search, an even share of at most ACC_CHUNK_COLS in
    the accumulator and of at most MIN_CHUNK_COLS in the min-only kernel."""
    if kernel in ("nn_bidir", "nn"):
        return M
    if kernel not in ("nn_bidir_acc", "nn_min_bidir"):
        raise ValueError(f"unknown kernel {kernel!r}")
    chunks = -(-M // (ACC_CHUNK_COLS if kernel == "nn_bidir_acc" else MIN_CHUNK_COLS))
    return -(-(-(-M // chunks)) // SWEEP_GROUP_COLS) * SWEEP_GROUP_COLS


def make_plan(S: int, N: int, M: int, sms: int, kernel: str, rows: int, cols: int,
              threads: int) -> SweepPlan | None:
    """The plan with these block parameters, or None where the kernel does
    not take them (what csrc/knn.cu sweep_params_ok and light_params_ok
    refuse)."""
    if kernel in _LIGHT_KERNELS:
        shared = light_shared_bytes(kernel, rows, cols, threads)
    elif kernel in _INDEXED_KERNELS:
        shared = sweep_shared_bytes(rows, cols, threads)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    if (rows <= 0 or rows % SWEEP_SUB_ROWS or threads < 32 or threads % 32
            or threads > SWEEP_MAX_THREADS or cols <= 0 or shared > SHARED_LIMIT
            or (kernel in ("nn_bidir", "nn") and cols != M)):
        return None
    row_blocks, chunks = -(-N // rows), -(-M // cols)
    scratch = {"nn_bidir": S * row_blocks * M * 8, "nn_bidir_acc": S * (N + M) * 8}.get(kernel, 0)
    return SweepPlan(kernel, rows, cols, threads, (row_blocks, chunks, S), shared,
                     _resident_blocks(shared, threads), scratch, sms)


def pick_bidir_plan(S: int, N: int, M: int, sms: int) -> SweepPlan:
    """The dispatch rule of nn_search_bidirectional: the per-tile kernel
    where it takes the shape and needs at most ACC_SCRATCH_BYTES of scratch,
    else the accumulator (which takes every shape)."""
    tile = plan_bidir(S, N, M, sms, "nn_bidir")
    if tile is not None and tile.scratch_bytes <= ACC_SCRATCH_BYTES:
        return tile
    return plan_bidir(S, N, M, sms, "nn_bidir_acc")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _launch_sweep(x, y, norm: int, plan: SweepPlan):
    """Allocate outputs and scratch, launch ``plan.kernel`` with the plan's
    block parameters (one call into the library: the sweep and whatever
    fill, fold or unpack kernel belongs to it) and count the launch.
    Returns ``(dx, ix, dy, iy)`` for the two indexed bidirectional kernels,
    ``(dx, ix)`` for ``"nn"`` and ``(dx, dy)`` for ``"nn_min_bidir"``."""
    lib = _cuda.library("knn")
    S, N, M = x.shape[0], x.shape[1], y.shape[1]
    dev = x.device
    head = (x.data_ptr(), y.data_ptr(), S, N, M, norm)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    if plan.kernel == "nn_min_bidir":
        # both directions' minima in one buffer, which the library fills with +inf
        both = empty(S * (N + M), torch.float32)
        out = (both[:S * N].view(S, N), both[S * N:].view(S, M))
        fn = lib.knn_min_bidir_launch
        args = (*head, plan.rows, plan.cols, plan.threads, both.data_ptr(), _cuda.stream(x))
    elif plan.kernel == "nn":
        out = (empty((S, N), torch.float32), empty((S, N), torch.int64))
        fn = lib.knn_nn_launch
        args = (*head, plan.rows, plan.threads, *(o.data_ptr() for o in out), _cuda.stream(x))
    else:
        out = (empty((S, N), torch.float32), empty((S, N), torch.int64),
               empty((S, M), torch.float32), empty((S, M), torch.int64))
        scratch = empty(plan.scratch_bytes // 8, torch.int64)
        if plan.kernel == "nn_bidir":
            fn, block = lib.knn_bidir_launch, (plan.rows, plan.threads)
            tail = (scratch.data_ptr(), _cuda.stream(x))
        else:
            fn, block = lib.knn_bidir_acc_launch, (plan.rows, plan.cols, plan.threads)
            tail = (scratch.data_ptr(), _ACC_INIT, _cuda.stream(x))
        args = (*head, *block, *(o.data_ptr() for o in out), *tail)
    err = _cuda.launch(fn, x, *args)
    _cuda.check(err, f"knn launch of {plan.kernel}")
    _cuda.launch_counts[plan.kernel] += 1
    return out


def _planned_launch(x, y, norm: int, kernel: str):
    x, y = _check_cuda(x, y)
    S, N, M = x.shape[0], x.shape[1], y.shape[1]
    return _launch_sweep(x, y, norm, plan_bidir(S, N, M, _sm_count(_device_index(x)), kernel))


def _nn_bidir_cuda(x, y, norm: int):
    """Replaces _nn_bidir_kernel (autourdf_tpu/ops/knn.py:149).  Bound on the
    H100 by the rate of unfused fp32 instructions (an L1 distance has
    no multiply-add to fuse), so the design cuts the instructions per pair:
    grouped minima with a deferred argmin, and the column side met once per
    block of ``rows`` x rows in shared memory.  No atomics: the blocks'
    (S, blocks, M) column partials are folded first-block-first by a second
    small kernel.  Raises for a shape whose 8 * M bytes of column state do
    not fit a block; see csrc/knn.cu for the design."""
    x, y = _check_cuda(x, y)
    S, N, M = x.shape[0], x.shape[1], y.shape[1]
    plan = plan_bidir(S, N, M, _sm_count(_device_index(x)), "nn_bidir")
    if plan is None:
        raise ValueError(f"the per-tile kernel holds 8 * M bytes of column state in shared "
                         f"memory and does not take M = {M}; use the accumulator kernel")
    return _launch_sweep(x, y, norm, plan)


def _fold_column_tiles(cmin: torch.Tensor, carg: torch.Tensor):
    """Plain version of fold_partials_kernel: fold per-block column partials
    ``(S, blocks, M)`` into the y -> x direction, first block on ties (the
    TPU fold at knn.py:226-230)."""
    tile_pick = torch.argmin(cmin, dim=1, keepdim=True)     # (S, 1, M)
    dy = torch.gather(cmin, 1, tile_pick)[:, 0]
    iy = torch.gather(carg, 1, tile_pick)[:, 0].long()
    return dy, iy


def _nn_min_bidir_cuda(x, y, norm: int):
    """Replaces _nn_min_bidir_kernel (autourdf_tpu/ops/knn.py:313).  Bound on
    the H100 by the rate of unfused fp32 instructions, and there is no index
    to defer: the design cuts the minima (one three-input integer minimum a
    pair on the distances' bits instead of two FMNMX), the shared loads (a
    thread holds 4 consecutive columns) and the atomics (the running column
    minimum stays in the block between its sub-tiles, so one atomicMin on
    the fp32 bits a block and column, sent only when it lowers the word).
    The +inf the words start from is filled by the same library call."""
    return _planned_launch(x, y, norm, "nn_min_bidir")


def _nn_cuda(x, y, norm: int):
    """Replaces _nn_kernel (autourdf_tpu/ops/knn.py:54).  Bound on the H100
    by the rate of unfused fp32 instructions (8 a pair at norm 2, none of
    them fused), so the design cuts what comes on top: the row side of the
    indexed sweep alone, the 4 columns a thread holds reduced by one
    three-input integer minimum and one FMNMX, one strictly-less update of
    (minimum, group base) a row and group instead of one a pair, and the
    argmin resolved once a row afterwards.  Row results only: no scratch, no atomics, every M in one
    chunk; rows and threads are planned per launch (100 clouds of 5,000
    points and 25,600 queries against 2,048 want different blocks)."""
    return _planned_launch(x, y, norm, "nn")


# (bits of +inf) << 32 | INT_MAX: above every (distance, index) word
_ACC_INIT = (0x7F800000 << 32) | 0x7FFFFFFF


def _nn_bidir_acc_cuda(x, y, norm: int):
    """Replaces _nn_bidir_acc_kernel (autourdf_tpu/ops/knn.py:233).  The same
    sweep as the per-tile kernel, bound by the same unfused fp32 rate,
    with no scratch beyond one 64-bit word per point: (distance bits,
    index), merged with atomicMin, so first-index ties are exact in any
    block order.  A block reads a column's word once and merges only when
    its (minimum, first row of the winning group) can still lower it; y is
    cut into column chunks across blocks, so every M is taken, and the row
    side meets through the same kind of word.  The column side's exact row
    is resolved after the blocks have met, by the last small kernel
    (unpack_words_kernel), which also unpacks the words."""
    return _planned_launch(x, y, norm, "nn_bidir_acc")


def _unpack_columns(packed: torch.Tensor):
    """Plain version of unpack_words_kernel: int64 words, distance bits high
    and index low -> (distance, index)."""
    dy = (packed >> 32).to(torch.int32).view(torch.float32)
    iy = packed & 0xFFFFFFFF
    return dy, iy


def _nn_bidir_auto_cuda(x, y, norm: int):
    """The kernel pick_bidir_plan chooses for the shape (the counterpart of
    the _bidir_vmem_ok dispatch at autourdf_tpu/ops/knn.py:429-444)."""
    x, y = _check_cuda(x, y)
    plan = pick_bidir_plan(x.shape[0], x.shape[1], y.shape[1], _sm_count(_device_index(x)))
    return _launch_sweep(x, y, norm, plan)


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
