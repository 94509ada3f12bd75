"""The algorithm of the port's two indexed search kernels
(autourdf_tpu_torch/csrc/knn.cu: bidir_sweep behind nn_bidir_kernel and
nn_bidir_acc_kernel), modelled here in plain PyTorch on the CPU and held
exactly against the plain version and the JAX package.

The model follows the kernel step by step: blocks of ``rows`` x rows and
``cols`` y columns, register sub-tiles of 32 rows, a thread's group of 4
consecutive columns (row side) and groups of 4 consecutive rows (column
side), grouped minima with a strictly-less update of (minimum, group),
the argmin resolved afterwards as the first member of the winning group that
equals the minimum (for the column side after the blocks have met),
per-block column partials folded first-block-first (per-tile kernel), and
64-bit (distance bits, index) words whose minimum is taken over blocks in a
shuffled order (accumulator kernel).  Distances come
from ``knn._pair_dist``, the plain version's arithmetic, as the kernel's
recomputed distances repeat its own.

Tolerance: none.  Indices are equal and distances bit-equal to
``knn._nn_bidir_plain``; against the JAX kernels (interpret mode) indices are
equal and distances bit-equal for norm 1, and within 1e-6 for norm 2, where
XLA may fuse the products into FMAs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from autourdf_tpu.ops import knn as jknn
from autourdf_tpu_torch.ops import knn

SUB, GROUP_ROWS, GROUP_COLS = knn.SWEEP_SUB_ROWS, knn.SWEEP_GROUP_ROWS, knn.SWEEP_GROUP_COLS
INF_BITS = 0x7F800000


def _bits(d: torch.Tensor) -> torch.Tensor:
    return d.contiguous().view(torch.int32).to(torch.int64)


def _pack(bits: int, idx: int) -> int:
    return (bits << 32) | idx


def _first_equal(values: torch.Tensor, target: float) -> int:
    hits = torch.nonzero(values == target)
    return int(hits[0]) if len(hits) else 0


def sweep_model(x, y, norm, kernel, rows, cols, threads, rng):
    """(dx, ix, dy, iy) of one batch, computed as bidir_sweep computes them."""
    S, N, M = x.shape[0], x.shape[1], y.shape[1]
    row_blocks, chunks = -(-N // rows), -(-M // cols)
    span = threads * GROUP_COLS
    inf = float("inf")
    dx = torch.empty(S, N)
    ix = torch.empty(S, N, dtype=torch.int64)
    cmin = torch.full((S, row_blocks, M), inf)
    carg = torch.zeros((S, row_blocks, M), dtype=torch.int32)
    row_words = torch.full((S, N), knn._ACC_INIT, dtype=torch.int64)
    col_words = torch.full((S, M), knn._ACC_INIT, dtype=torch.int64)
    blocks = [(s, rb, cb) for s in range(S) for rb in range(row_blocks) for cb in range(chunks)]
    if kernel == "nn_bidir_acc":
        blocks = [blocks[k] for k in rng.permutation(len(blocks))]   # blocks run in no order
    for s, rb, cb in blocks:
        row0, col0 = rb * rows, cb * cols
        col_end = min(M, col0 + cols)
        passes = -(-(col_end - col0) // span)
        width = passes * span
        # the block's distances, +inf where a row or a column is padding
        dist = torch.full((rows, width), inf)
        live = knn._pair_dist(x[s:s + 1, row0:row0 + rows], y[s:s + 1, col0:col_end], norm)[0]
        dist[:live.shape[0], :live.shape[1]] = live
        col_min = torch.full((width,), inf)
        col_grp = torch.zeros(width, dtype=torch.int64)
        nsub = -(-min(rows, N - row0) // SUB)
        for sub in range(nsub):
            tile = dist[sub * SUB:(sub + 1) * SUB]                    # (32, width)
            # row side: a thread's group minima, pass by pass, strictly-less
            gmin = tile.view(SUB, passes, threads, GROUP_COLS).amin(-1)  # (32, passes, threads)
            first_pass = torch.argmin(gmin, dim=1)                    # first pass on ties
            rmin = gmin.amin(1)                                       # (32, threads)
            slot = (first_pass * threads + torch.arange(threads)) * GROUP_COLS
            rbase = torch.where(rmin < inf, col0 + slot, torch.full_like(slot, col0))
            # fold over threads: minimum, then the lowest group base holding it
            low = rmin.amin(1)
            base = torch.where(rmin == low[:, None], rbase,
                               torch.full_like(rbase, 0x7FFFFFFF)).amin(1)
            for i in range(SUB):
                r = row0 + sub * SUB + i
                if r >= N:
                    continue
                b = int(base[i])
                members = tile[i, b - col0:min(b + GROUP_COLS, col_end) - col0]
                idx = b + _first_equal(members, float(low[i]))
                if kernel == "nn_bidir":
                    dx[s, r], ix[s, r] = low[i], idx
                else:
                    word = _pack(int(_bits(low[i:i + 1])), idx)
                    if word < int(row_words[s, r]):
                        row_words[s, r] = word
            # column side: minima of groups of 4 rows, ascending, strictly-less
            for g in range(SUB // GROUP_ROWS):
                glow = tile[g * GROUP_ROWS:(g + 1) * GROUP_ROWS].amin(0)
                better = glow < col_min
                col_min = torch.where(better, glow, col_min)
                col_grp = torch.where(better, torch.full_like(col_grp, sub * (SUB // GROUP_ROWS) + g),
                                      col_grp)
        # the block's column results leave it once: the minimum and the first
        # row of the row group that holds it
        for j in range(col0, col_end):
            k = j - col0
            group_row = row0 + int(col_grp[k]) * GROUP_ROWS
            if kernel == "nn_bidir":
                cmin[s, rb, j], carg[s, rb, j] = col_min[k], group_row
                continue
            word = _pack(int(_bits(col_min[k:k + 1])), group_row)
            if word < int(col_words[s, j]):
                col_words[s, j] = word
    if kernel == "nn_bidir":
        dy = torch.full((S, M), inf)
        group_rows = torch.zeros((S, M), dtype=torch.int64)
        for rb in range(row_blocks):        # first block on ties
            better = cmin[:, rb] < dy
            dy = torch.where(better, cmin[:, rb], dy)
            group_rows = torch.where(better, carg[:, rb].long(), group_rows)
        fold = knn._fold_column_tiles(cmin, carg)
        assert torch.equal(fold[0], dy) and torch.equal(fold[1], group_rows)
    else:
        dx, ix = knn._unpack_columns(row_words)
        dy, group_rows = knn._unpack_columns(col_words)
    # the deferred argmin of the column side, after the blocks have met
    iy = torch.empty((S, M), dtype=torch.int64)
    for s in range(S):
        for j in range(M):
            g = int(group_rows[s, j])
            members = knn._pair_dist(x[s:s + 1, g:g + GROUP_ROWS], y[s:s + 1, j:j + 1], norm)
            iy[s, j] = g + _first_equal(members[0, :, 0], float(dy[s, j]))
    return dx, ix, dy, iy


def tie_clouds(rng, S, N, M, values=None):
    """Ties placed against the design: an x row equal to a y point and
    copied to rows in the same group of 4, another group, another sub-tile
    and other blocks; the y point copied to columns of the same thread's
    group, other threads, other passes and other chunks; one y point
    reached by every 7th row."""
    if values is None:
        x = rng.uniform(-0.3, 0.3, (S, N, 3))
        y = rng.uniform(-0.3, 0.3, (S, M, 3))
    else:
        x, y = rng.choice(values, (S, N, 3)), rng.choice(values, (S, M, 3))
    x, y = x.astype(np.float32), y.astype(np.float32)
    if M > 5:
        x[:, 3::7] = y[:, 5:6]
    for b, j in ((0, 0), (6, 2), (N // 2 + 1, M // 2 + 3), (N - 2, M - 2)):
        if not (0 <= b < N and 0 <= j < M):
            continue
        x[:, b] = y[:, j]
        for off in (1, 2, 5, 33, 35, 66, 70, 131):
            if b + off < N:
                x[:, b + off] = x[:, b]
        for off in (1, 3, 4, 9, 40, 130, 135, 200):
            if j + off < M:
                y[:, j + off] = y[:, j]
    return torch.from_numpy(x), torch.from_numpy(y)


def _assert_exact(got, ref):
    for name, a, b in zip(("dx", "ix", "dy", "iy"), got, ref):
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name


# (kernel, rows, cols (None: all of y), threads), the cases that differ in
# design: one sub-tile a block or several (no column state in shared memory,
# or state carried between sub-tiles), one column chunk or several (the row
# side meets inside the block only, or across blocks through the words)
CONFIGS = [("nn_bidir", 32, None, 32), ("nn_bidir", 96, None, 64),
           ("nn_bidir_acc", 64, 132, 32), ("nn_bidir_acc", 128, 1024, 64)]
# one point; ragged with N > M and with N < M (several passes of the threads)
SHAPES = [(1, 1, 1), (2, 130, 67), (1, 161, 259)]


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_model_of_the_sweep_equals_plain(shape, config, norm):
    S, N, M = shape
    kernel, rows, cols, threads = config
    rng = np.random.default_rng(N * 1000 + M + norm)
    x, y = tie_clouds(rng, S, N, M)
    got = sweep_model(x, y, norm, kernel, rows, cols or M, threads, rng)
    _assert_exact(got, knn._nn_bidir_plain(x, y, norm))


@pytest.mark.parametrize("kernel,norm", [("nn_bidir", 1), ("nn_bidir_acc", 2)])
@pytest.mark.parametrize("case", ["zero_distances", "all_sentinel_y", "sentinel_padded",
                                  "one_point_everywhere"])
def test_model_on_degenerate_clouds(case, kernel, norm):
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.3, 0.3, (2, 100, 3)).astype(np.float32)
    y = rng.uniform(-0.3, 0.3, (2, 90, 3)).astype(np.float32)
    if case == "zero_distances":
        x[:, 10:60] = y[:, 20:70]
    elif case == "all_sentinel_y":
        y[:] = knn.PAD_COORD
    elif case == "sentinel_padded":
        x[:, 70:] = knn.PAD_COORD
        y[:, 50:] = knn.PAD_COORD
    else:
        x[:] = x[:, :1]
        y[:] = x[:, :1]
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    cols = 90 if kernel == "nn_bidir" else 40
    got = sweep_model(x, y, norm, kernel, 64, cols, 32, rng)
    _assert_exact(got, knn._nn_bidir_plain(x, y, norm))
    assert not bool(torch.signbit(got[0]).any() or torch.signbit(got[2]).any())


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 80), m=st.integers(1, 80),
       norm=st.sampled_from([1, 2]), config=st.sampled_from(CONFIGS[:3]))
def test_model_with_ties_everywhere(seed, n, m, norm, config):
    """Coordinates from a three-value set: almost every minimum is tied."""
    kernel, rows, cols, threads = config
    rng = np.random.default_rng(seed)
    x, y = tie_clouds(rng, 1, n, m, values=np.array([0.0, 0.5, 1.0]))
    got = sweep_model(x, y, norm, kernel, rows, cols or m, threads, rng)
    _assert_exact(got, knn._nn_bidir_plain(x, y, norm))


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("kernel", ["nn_bidir", "nn_bidir_acc"])
def test_model_equals_the_tpu_kernels_in_interpret_mode(kernel, norm):
    rng = np.random.default_rng(11)
    x, y = tie_clouds(rng, 1, 130, 67)
    cols = 67 if kernel == "nn_bidir" else 32
    got = sweep_model(x, y, norm, kernel, 64, cols, 32, rng)
    jx, jy = jnp.asarray(x[0].numpy()), jnp.asarray(y[0].numpy())
    for ref in (jknn._nn_bidir_pallas(jx, jy, norm, 64, interpret=True),
                jknn._nn_bidir_pallas_acc(jx, jy, norm, 64, interpret=True)):
        np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[3][0].numpy(), np.asarray(ref[3]))
        for a, b in ((got[0], ref[0]), (got[2], ref[2])):
            if norm == 1:
                np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
            else:       # XLA may fuse d*d + ... into FMAs: a last-bit difference
                np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_words_round_trip_and_order():
    d = torch.tensor([[0.0, 0.0, 1e-30, 0.5, 3e12, float("inf"), float("inf")]])
    i = torch.tensor([[0, 2**31 - 1, 7, 19999, 5, 0, 2**31 - 1]])
    words = (_bits(d) << 32) | i
    assert int(words[0, -1]) == knn._ACC_INIT == _pack(INF_BITS, 2**31 - 1)
    assert torch.equal(torch.sort(words, dim=1, stable=True).indices[0], torch.arange(7))
    back_d, back_i = knn._unpack_columns(words)
    assert torch.equal(back_d, d) and torch.equal(back_i, i)
    assert back_d.dtype == torch.float32 and back_i.dtype == torch.int64
    # as the unsigned 64-bit integers the kernel compares, every word is below
    # 2**63, so the signed order of the int64 tensor is the same order
    assert int(words.max()) == knn._ACC_INIT < 2**63


PLAN_SHAPES = [(1, 1, 1), (5, 4988, 4988), (5, 5000, 5000), (2, 4418, 4985), (1, 20000, 20000),
               (100, 4988, 4988), (1, 100, 28672), (1, 100, 28673), (1, 33, 100000),
               (9, 25600, 2048), (65535, 40, 40), (1, 30, 200000)]


@pytest.mark.parametrize("sms", [132, 108, 16])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plans_fit_the_block_and_cover_the_clouds(shape, sms):
    S, N, M = shape
    for kernel in ("nn_bidir", "nn_bidir_acc"):
        plan = knn.plan_bidir(S, N, M, sms, kernel)
        if plan is None:
            assert kernel == "nn_bidir"     # the accumulator takes every shape
            continue
        assert plan.shared_bytes == knn.sweep_shared_bytes(plan.rows, plan.cols, plan.threads)
        assert 0 < plan.shared_bytes <= knn.SHARED_LIMIT == 232_448
        assert plan.rows % knn.SWEEP_SUB_ROWS == 0 and plan.rows > 0
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= knn.SWEEP_MAX_THREADS
        assert all(g >= 1 for g in plan.grid) and plan.blocks >= 1
        assert plan.grid[2] == S <= 65535 and plan.grid[1] <= 65535
        assert plan.grid[0] * plan.rows >= N > (plan.grid[0] - 1) * plan.rows
        assert plan.grid[1] * plan.cols >= M > (plan.grid[1] - 1) * plan.cols
        assert plan.resident >= 1
        assert N <= knn.SWEEP_SUB_ROWS or plan.rows >= 2 * knn.SWEEP_SUB_ROWS
        if kernel == "nn_bidir":
            assert plan.grid[1] == 1 and plan.cols == M
            assert plan.scratch_bytes == S * plan.grid[0] * M * 8
        else:
            assert plan.cols <= knn.ACC_CHUNK_COLS and plan.scratch_bytes == S * (N + M) * 8
    picked = knn.pick_bidir_plan(S, N, M, sms)
    tile = knn.plan_bidir(S, N, M, sms, "nn_bidir")
    if tile is None or tile.scratch_bytes > knn.ACC_SCRATCH_BYTES:
        assert picked.kernel == "nn_bidir_acc"
    else:
        assert picked == tile


def test_dispatch_rule_at_the_shapes_of_the_paths():
    # the registration's production shape stays on the per-tile kernel, the
    # large clouds and an oversize M go to the accumulator, by rule
    assert knn.pick_bidir_plan(5, 4988, 4988, 132).kernel == "nn_bidir"
    assert knn.pick_bidir_plan(2, 4988, 4988, 132).kernel == "nn_bidir"
    assert knn.pick_bidir_plan(1, 20000, 20000, 132).kernel == "nn_bidir_acc"
    largest = max(m for m in range(28000, 29500) if knn.plan_bidir(1, 100, m, 132, "nn_bidir"))
    assert knn.plan_bidir(1, 100, largest, 132, "nn_bidir").shared_bytes <= knn.SHARED_LIMIT
    assert knn.plan_bidir(1, 100, largest + 1, 132, "nn_bidir") is None
    assert knn.pick_bidir_plan(1, 100, largest, 132).kernel == "nn_bidir"
    assert knn.pick_bidir_plan(1, 100, largest + 1, 132).kernel == "nn_bidir_acc"
    # x of at most one sub-tile has no column state: every M is taken
    assert knn.plan_bidir(1, 30, 200000, 132, "nn_bidir").shared_bytes < 8192


def test_make_plan_refuses_what_the_kernel_refuses():
    ok = knn.make_plan(1, 100, 100, 132, "nn_bidir", 64, 100, 128)
    assert ok is not None and ok.grid == (2, 1, 1)
    for rows, cols, threads in ((48, 100, 128), (0, 100, 128), (64, 100, 100), (64, 100, 1024),
                                (64, 0, 128), (64, 50, 128), (64, 40000, 128)):
        kernel = "nn_bidir" if cols in (100, 50) else "nn_bidir_acc"
        assert knn.make_plan(1, 100, 100, 132, kernel, rows, cols, threads) is None
