"""The algorithms of the port's four search kernels
(autourdf_tpu_torch/csrc/knn.cu: bidir_sweep behind nn_bidir_kernel and
nn_bidir_acc_kernel, light_sweep behind nn_kernel and nn_min_bidir_kernel),
modelled here in plain PyTorch on the CPU and held exactly against the plain
versions and the JAX package.

The models follow the kernels step by step: blocks of ``rows`` x rows and
``cols`` y columns, register sub-tiles of 32 rows, a thread's group of 4
consecutive columns (row side) and groups of 4 consecutive rows (column
side of the indexed sweep), grouped minima with a strictly-less update of
(minimum, group), the argmin resolved afterwards as the first member of the
winning group that equals the minimum (for the column side after the blocks
have met), per-block column partials folded first-block-first (per-tile
kernel), 64-bit (distance bits, index) words whose minimum is taken over
blocks in a shuffled order (accumulator kernel), and the bits of fp32 minima
merged over blocks in a shuffled order (min-only kernel).  Distances come
from ``knn._pair_dist``, the plain version's arithmetic, as the kernels'
recomputed distances repeat their own.  Two mutations of the row side's
first-index rule (update on less-or-equal, resolve to the last equal member)
must fail the comparison.

Tolerance: none.  Indices are equal and distances bit-equal to the plain
versions; against the JAX kernels (interpret mode) indices are equal and
distances bit-equal for norm 1, and within 1e-6 for norm 2, where XLA may
fuse the products into FMAs.
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


def _row_side(tile, passes, threads, col0, col_end, update="less", resolve="first"):
    """(minimum, argmin) of the 32 rows of a sub-tile over the block's
    columns, as a sweep's row side takes them.  ``update`` and ``resolve``
    are the first-index rule ("less", "first") or a mutation of it."""
    inf = float("inf")
    # a thread's group minima, pass by pass, strictly-less: the first pass wins
    gmin = tile.view(SUB, passes, threads, GROUP_COLS).amin(-1)      # (32, passes, threads)
    if update == "less":
        pick = torch.argmin(gmin, dim=1)
    else:                           # less-or-equal: the last pass that reaches the minimum
        pick = passes - 1 - torch.argmin(gmin.flip(1), dim=1)
    rmin = gmin.amin(1)                                               # (32, threads)
    slot = (pick * threads + torch.arange(threads)) * GROUP_COLS
    rbase = torch.where(rmin < inf, col0 + slot, torch.full_like(slot, col0))
    # fold over threads: minimum, then the lowest group base holding it
    low = rmin.amin(1)
    base = torch.where(rmin == low[:, None], rbase, torch.full_like(rbase, 0x7FFFFFFF)).amin(1)
    idx = torch.empty(SUB, dtype=torch.int64)
    for i in range(SUB):
        b = int(base[i])
        hits = torch.nonzero(tile[i, b - col0:min(b + GROUP_COLS, col_end) - col0] == low[i])
        idx[i] = b + (0 if len(hits) == 0 else int(hits[0] if resolve == "first" else hits[-1]))
    return low, idx


def _block_distances(x, y, norm, s, row0, rows, col0, col_end, width):
    """The block's distances, +inf where a row or a column is padding."""
    dist = torch.full((rows, width), float("inf"))
    live = knn._pair_dist(x[s:s + 1, row0:row0 + rows], y[s:s + 1, col0:col_end], norm)[0]
    dist[:live.shape[0], :live.shape[1]] = live
    return dist


def sweep_model(x, y, norm, kernel, rows, cols, threads, rng, update="less", resolve="first"):
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
        dist = _block_distances(x, y, norm, s, row0, rows, col0, col_end, width)
        col_min = torch.full((width,), inf)
        col_grp = torch.zeros(width, dtype=torch.int64)
        nsub = -(-min(rows, N - row0) // SUB)
        for sub in range(nsub):
            tile = dist[sub * SUB:(sub + 1) * SUB]                    # (32, width)
            low, idx = _row_side(tile, passes, threads, col0, col_end, update, resolve)
            for i in range(SUB):
                r = row0 + sub * SUB + i
                if r >= N:
                    continue
                if kernel == "nn_bidir":
                    dx[s, r], ix[s, r] = low[i], idx[i]
                else:
                    word = _pack(int(_bits(low[i:i + 1])), int(idx[i]))
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


def light_model(x, y, norm, kernel, rows, cols, threads, rng, update="less", resolve="first"):
    """``(dx, ix)`` of nn_kernel or ``(dx, dy)`` of nn_min_bidir_kernel for one
    batch, computed as light_sweep computes them."""
    S, N, M = x.shape[0], x.shape[1], y.shape[1]
    row_blocks, chunks = -(-N // rows), -(-M // cols)
    assert kernel == "nn_min_bidir" or chunks == 1    # nn_kernel never cuts y
    span = threads * GROUP_COLS
    dx = torch.empty(S, N)
    ix = torch.empty(S, N, dtype=torch.int64)
    row_bits = torch.full((S, N), INF_BITS, dtype=torch.int64)      # what the fill kernel writes
    col_bits = torch.full((S, M), INF_BITS, dtype=torch.int64)
    blocks = [(s, rb, cb) for s in range(S) for rb in range(row_blocks) for cb in range(chunks)]
    for s, rb, cb in (blocks[k] for k in rng.permutation(len(blocks))):   # in no order
        row0, col0 = rb * rows, cb * cols
        col_end = min(M, col0 + cols)
        passes = -(-(col_end - col0) // span)
        dist = _block_distances(x, y, norm, s, row0, rows, col0, col_end, passes * span)
        col_min = torch.full((passes * span,), float("inf"))
        for sub in range(-(-min(rows, N - row0) // SUB)):
            tile = dist[sub * SUB:(sub + 1) * SUB]
            low, idx = _row_side(tile, passes, threads, col0, col_end, update, resolve)
            live = min(SUB, N - row0 - sub * SUB)
            at = slice(row0 + sub * SUB, row0 + sub * SUB + live)
            if kernel == "nn":
                dx[s, at], ix[s, at] = low[:live], idx[:live]
            else:
                row_bits[s, at] = torch.minimum(row_bits[s, at], _bits(low[:live]))
                col_min = torch.minimum(col_min, tile.amin(0))      # kept between sub-tiles
        # the block's column minima leave it once
        col_bits[s, col0:col_end] = torch.minimum(col_bits[s, col0:col_end],
                                                  _bits(col_min[:col_end - col0]))
    if kernel == "nn":
        return dx, ix
    return tuple(b.to(torch.int32).view(torch.float32) for b in (row_bits, col_bits))


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
    for k, (a, b) in enumerate(zip(got, ref, strict=True)):
        assert a.dtype == b.dtype, k
        assert torch.equal(a, b), k


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


# (kernel, rows, cols (None: all of y), threads), the cases of light_sweep that
# differ in design: one warp or several (the meeting of the warps), one
# sub-tile a block or several (the column minimum kept between sub-tiles),
# one column chunk or several (the row side merged across blocks)
LIGHT_CONFIGS = [("nn", 32, None, 32), ("nn", 64, None, 64),
                 ("nn_min_bidir", 32, None, 32), ("nn_min_bidir", 96, 132, 64)]
LIGHT_PLAIN = {"nn": knn._nn_plain, "nn_min_bidir": knn._nn_min_bidir_plain}
light_ids = pytest.mark.parametrize("config", LIGHT_CONFIGS,
                                    ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")


@pytest.mark.parametrize("norm", [1, 2])
@light_ids
@pytest.mark.parametrize("shape", SHAPES + [(1, 20, 3)], ids=lambda s: "x".join(map(str, s)))
def test_model_of_the_light_sweep_equals_plain(shape, config, norm):
    S, N, M = shape
    kernel, rows, cols, threads = config
    rng = np.random.default_rng(N * 1000 + M + norm)
    x, y = tie_clouds(rng, S, N, M)
    got = light_model(x, y, norm, kernel, rows, cols or M, threads, rng)
    _assert_exact(got, LIGHT_PLAIN[kernel](x, y, norm))


@pytest.mark.parametrize("kernel,norm", [("nn", 2), ("nn_min_bidir", 1)])
@pytest.mark.parametrize("case", ["zero_distances", "all_sentinel_y", "sentinel_padded",
                                  "one_point_everywhere"])
def test_light_model_on_degenerate_clouds(case, kernel, norm):
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
    got = light_model(x, y, norm, kernel, 64, 90 if kernel == "nn" else 40, 32, rng)
    _assert_exact(got, LIGHT_PLAIN[kernel](x, y, norm))
    assert not bool(torch.signbit(got[0]).any())
    if case == "all_sentinel_y" and kernel == "nn":
        assert int(got[1].abs().max()) == 0 and bool(torch.isfinite(got[0]).all())


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 80), m=st.integers(1, 80),
       norm=st.sampled_from([1, 2]), config=st.sampled_from(LIGHT_CONFIGS))
def test_light_model_with_ties_everywhere(seed, n, m, norm, config):
    """Coordinates from a three-value set: almost every minimum is tied."""
    kernel, rows, cols, threads = config
    rng = np.random.default_rng(seed)
    x, y = tie_clouds(rng, 1, n, m, values=np.array([0.0, 0.5, 1.0]))
    got = light_model(x, y, norm, kernel, rows, cols or m, threads, rng)
    _assert_exact(got, LIGHT_PLAIN[kernel](x, y, norm))


@pytest.mark.parametrize("norm", [1, 2])
@light_ids
def test_light_model_equals_the_tpu_kernels_in_interpret_mode(config, norm):
    kernel, rows, cols, threads = config
    rng = np.random.default_rng(12)
    x, y = tie_clouds(rng, 1, 130, 67)
    got = light_model(x, y, norm, kernel, rows, 67 if cols is None else 32, threads, rng)
    jx, jy = jnp.asarray(x[0].numpy()), jnp.asarray(y[0].numpy())
    if kernel == "nn":
        ref = jknn.nn_search(jx, jy, norm, "pallas_interpret")
        np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(ref[1]))
        pairs = [(got[0], ref[0])]
    else:
        pairs = list(zip(got, jknn._nn_min_bidir_pallas(jx, jy, norm, 64, True)))
    for a, b in pairs:
        if norm == 1:
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
        else:           # XLA may fuse d*d + ... into FMAs: a last-bit difference
            np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("mutation", [("less_equal", "first"), ("less", "last")],
                         ids=["update-on-less-or-equal", "resolve-to-last-equal"])
@pytest.mark.parametrize("kernel", ["nn", "nn_bidir"])
def test_mutations_of_the_first_index_rule_fail(kernel, mutation, norm):
    """The tie clouds tell the first-index rule from its neighbours: a row
    side that updates on less-or-equal (the last pass wins) or resolves to
    the last equal member of the group returns other indices than plain."""
    rng = np.random.default_rng(13)
    x, y = tie_clouds(rng, 1, 161, 259)
    update, resolve = mutation
    if kernel == "nn":
        got = light_model(x, y, norm, "nn", 64, 259, 32, rng, update, resolve)
        right = light_model(x, y, norm, "nn", 64, 259, 32, rng)
    else:
        got = sweep_model(x, y, norm, "nn_bidir", 64, 259, 32, rng, update, resolve)
        right = sweep_model(x, y, norm, "nn_bidir", 64, 259, 32, rng)
    ref = knn._nn_plain(x, y, norm)
    assert torch.equal(right[0], ref[0]) and torch.equal(right[1], ref[1])
    assert torch.equal(got[0], ref[0])              # the minima do not care
    assert not torch.equal(got[1], ref[1])          # the indices do


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


@pytest.mark.parametrize("sms", [132, 108, 16])
@pytest.mark.parametrize("shape", PLAN_SHAPES + [(3, 1, 700), (3, 700, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_light_plans_fit_the_block_and_cover_the_clouds(shape, sms):
    S, N, M = shape
    for kernel in ("nn", "nn_min_bidir"):
        plan = knn.plan_bidir(S, N, M, sms, kernel)         # every shape is taken
        assert plan.kernel == kernel and plan.scratch_bytes == 0
        assert plan.shared_bytes == knn.light_shared_bytes(kernel, plan.rows, plan.cols,
                                                           plan.threads)
        assert 0 < plan.shared_bytes <= knn.SHARED_LIMIT
        assert plan.rows % knn.SWEEP_SUB_ROWS == 0 and plan.rows > 0
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= knn.SWEEP_MAX_THREADS
        assert plan.grid[2] == S <= 65535 and 1 <= plan.grid[1] <= 65535
        assert plan.grid[0] * plan.rows >= N > (plan.grid[0] - 1) * plan.rows
        assert plan.grid[1] * plan.cols >= M > (plan.grid[1] - 1) * plan.cols
        assert plan.resident >= 1
        assert plan == knn.make_plan(S, N, M, sms, kernel, plan.rows, plan.cols, plan.threads)
        if kernel == "nn":
            assert plan.grid[1] == 1 and plan.cols == M     # y is never cut
        else:
            assert plan.cols <= knn.MIN_CHUNK_COLS and plan.cols % knn.SWEEP_GROUP_COLS == 0
            # the column side meets over at least two sub-tiles where x has them
            assert N <= knn.SWEEP_SUB_ROWS or plan.rows >= 2 * knn.SWEEP_SUB_ROWS


def test_plans_at_the_shapes_they_were_fitted_to():
    """The block shapes the H100 sweeps chose (132 SMs): a change of a
    planning weight that moves one of them wants a new sweep on the card."""
    picks = {("nn_bidir", 5, 4988, 4988): (96, 4988, 256),
             ("nn_bidir_acc", 1, 20000, 20000): (64, 2500, 128),
             ("nn", 100, 4988, 4988): (64, 4988, 32),
             ("nn", 9, 25600, 2048): (64, 2048, 32),
             ("nn", 5, 4988, 4988): (32, 4988, 64),
             ("nn_min_bidir", 100, 4988, 4988): (384, 4988, 256),
             ("nn_min_bidir", 9, 25600, 2048): (160, 2048, 128),
             ("nn_min_bidir", 5, 4988, 4988): (96, 4988, 256)}
    for (kernel, S, N, M), want in picks.items():
        plan = knn.plan_bidir(S, N, M, 132, kernel)
        assert (plan.rows, plan.cols, plan.threads) == want, kernel


def test_make_plan_takes_light_block_shapes_and_refuses_bad_ones():
    assert knn.make_plan(1, 100, 100, 132, "nn", 512, 100, 32).grid == (1, 1, 1)
    assert knn.make_plan(1, 100, 100, 132, "nn_min_bidir", 64, 48, 64).grid == (2, 3, 1)
    assert knn.make_plan(1, 100, 100, 132, "nn", 64, 50, 64) is None        # nn never cuts y
    for rows, cols, threads in ((48, 100, 128), (0, 100, 128), (64, 100, 100), (64, 100, 1024),
                                (64, 0, 128)):
        for kernel in ("nn", "nn_min_bidir"):
            assert knn.make_plan(1, 100, 100, 132, kernel, rows, cols, threads) is None
    # 4 bytes of column state a slot: a chunk of 100,000 columns does not fit
    assert knn.make_plan(1, 100, 100000, 132, "nn_min_bidir", 64, 100000, 128) is None
    with pytest.raises(ValueError):
        knn.make_plan(1, 100, 100, 132, "nn_forward", 64, 100, 128)
