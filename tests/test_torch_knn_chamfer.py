"""Parity of the port's nearest-neighbour search and Chamfer loss
(autourdf_tpu_torch.ops.knn / .chamfer) with the JAX package on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode and its XLA path.
Distances agree to 1e-6 (fp32, the same elementwise arithmetic; XLA may
fuse the norm-2 products into FMAs, a last-bit difference) and indices
exactly, first index on ties.  Chamfer values and gradients agree to 1e-6
relative / absolute: the matched neighbours are the same, only the order
of the mean's sum differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autourdf_tpu.ops import chamfer as jch
from autourdf_tpu.ops import knn as jknn
from autourdf_tpu_torch.ops import chamfer as tch
from autourdf_tpu_torch.ops import knn as tknn

PAD = jknn.PAD_COORD


def _clouds(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "ragged_multi_tile":       # > 1 x-tile of the TPU kernel (tx=512)
        x, y = rng.normal(size=(700, 3)), rng.normal(size=(333, 3))
    elif kind == "sentinel_padded":
        x = np.concatenate([rng.normal(size=(90, 3)), np.full((38, 3), PAD)])
        y = np.concatenate([rng.normal(size=(70, 3)), np.full((58, 3), PAD)])
    else:                                 # "ties": duplicated points both ways
        x, y = rng.normal(size=(600, 3)), rng.normal(size=(250, 3))
        y[200:240] = y[0:40]
        x[550:600] = x[0:50]
        x[100:120] = y[10:30]
    return x.astype(np.float32), y.astype(np.float32)


CASES = ["ragged_multi_tile", "sentinel_padded", "ties"]


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_nn_search_bidirectional_parity(case, norm, backend):
    x, y = _clouds(case)
    jd = jknn.nn_search_bidirectional(jnp.asarray(x), jnp.asarray(y), norm, backend)
    td = tknn.nn_search_bidirectional(torch.from_numpy(x), torch.from_numpy(y), norm)
    for a, b in ((jd[0], td[0]), (jd[2], td[2])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(td[1].numpy(), np.asarray(jd[1]))
    np.testing.assert_array_equal(td[3].numpy(), np.asarray(jd[3]))


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_nn_min_bidirectional_parity(case, norm, backend):
    x, y = _clouds(case, seed=1)
    jd = jknn.nn_min_bidirectional(jnp.asarray(x), jnp.asarray(y), norm, backend)
    td = tknn.nn_min_bidirectional(torch.from_numpy(x), torch.from_numpy(y), norm)
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)


def test_sequence_batch_equals_per_sequence():
    # the (S, N, 3) batch the registration driver passes: each sequence
    # matches the JAX search on that sequence alone
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 150, 3)).astype(np.float32)
    y = rng.normal(size=(3, 170, 3)).astype(np.float32)
    tb = tknn.nn_search_bidirectional(torch.from_numpy(x), torch.from_numpy(y), 1)
    tm = tknn.nn_min_bidirectional(torch.from_numpy(x), torch.from_numpy(y), 1)
    for s in range(3):
        jd = jknn.nn_search_bidirectional(jnp.asarray(x[s]), jnp.asarray(y[s]), 1, "xla")
        for a, b in zip(jd, tb):
            np.testing.assert_allclose(b[s].numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tm[0][s].numpy(), np.asarray(jd[0]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tm[1][s].numpy(), np.asarray(jd[2]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [0, 1, 31, 33, 157, 4988, 100003])
def test_row_sums_per_row_and_against_float64(n):
    """``ops.reduce.row_sums`` gives each row the sum it gets alone, bit for
    bit, within float32 rounding of the float64 sum."""
    from autourdf_tpu_torch.ops.reduce import row_sums

    v = torch.from_numpy(np.random.default_rng(n).normal(size=(2, 5, n)).astype(np.float32))
    got = row_sums(v)
    assert got.shape == (2, 5)
    for i in range(5):
        torch.testing.assert_close(row_sums(v[:, i]), got[:, i], rtol=0, atol=0)
        torch.testing.assert_close(row_sums(v[1, i]), got[1, i], rtol=0, atol=0)
    np.testing.assert_allclose(got.double().numpy(), v.double().sum(-1).numpy(), rtol=0,
                               atol=2e-7 * max(n, 1) ** 0.5 * 8)


def test_column_tile_fold_first_tile_on_ties():
    # the fold the CUDA wrapper applies to the kernel's (S, tiles, M)
    # partials: minimum over tiles, the first tile winning a tie
    cmin = torch.tensor([[[3.0, 1.0, 2.0], [1.0, 1.0, 5.0], [1.0, 0.5, 2.0]]])
    carg = torch.tensor([[[0, 1, 2], [64, 65, 66], [128, 129, 130]]], dtype=torch.int32)
    dy, iy = tknn._fold_column_tiles(cmin, carg)
    assert dy.tolist() == [[1.0, 0.5, 2.0]]
    assert iy.tolist() == [[64, 129, 2]]
    assert iy.dtype == torch.int64


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        tknn.nn_search_bidirectional(x, torch.zeros(5, 2))
    with pytest.raises(ValueError):
        tknn.nn_min_bidirectional(x, torch.zeros(0, 3))
    with pytest.raises(ValueError):
        tknn.nn_search_bidirectional(x, torch.zeros(5, 3), norm=3)
    with pytest.raises(ValueError):   # no plain fallback off the CPU
        tknn.nn_search_bidirectional(x.to("meta"), torch.zeros(5, 3, device="meta"))


def _masks(rng, n, m, masked):
    if not masked:
        return None, None
    return rng.random(n) > 0.2, rng.random(m) > 0.2


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("norm", [1, 2])
def test_chamfer_value_and_grad_parity(norm, masked):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(130, 3)).astype(np.float32)
    y = rng.normal(size=(110, 3)).astype(np.float32)
    xm, ym = _masks(rng, 130, 110, masked)
    jm = [None if v is None else jnp.asarray(v) for v in (xm, ym)]
    jl, (jgx, jgy) = jax.value_and_grad(
        lambda a, b: jch.chamfer_distance(a, b, *jm, norm=norm, backend="xla"),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))

    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    tm = [None if v is None else torch.from_numpy(v) for v in (xm, ym)]
    tl = tch.chamfer_distance(xt, yt, *tm, norm=norm)
    tgx, tgy = torch.autograd.grad(tl, (xt, yt))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), atol=1e-6)
    np.testing.assert_allclose(tgy.numpy(), np.asarray(jgy), atol=1e-6)
    # forward-only call (the min-only search) gives the same value
    with torch.no_grad():
        fwd = tch.chamfer_distance(xt, yt, *tm, norm=norm)
    np.testing.assert_allclose(float(fwd), float(jl), rtol=1e-6)


def test_chamfer_batched_matches_jax_vmap():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 64, 3)).astype(np.float32)
    y = rng.normal(size=(3, 80, 3)).astype(np.float32)
    xm = rng.random((3, 64)) > 0.3
    ym = rng.random((3, 80)) > 0.3
    fn = lambda a, b, am, bm: jch.chamfer_distance(a, b, am, bm, backend="xla")
    jl, jg = jax.vmap(jax.value_and_grad(fn))(*(jnp.asarray(v) for v in (x, y, xm, ym)))
    xt = torch.from_numpy(x).requires_grad_(True)
    tl = tch.chamfer_distance(xt, torch.from_numpy(y), torch.from_numpy(xm),
                              torch.from_numpy(ym))
    (tg,) = torch.autograd.grad(tl.sum(), xt)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_from_indices_parity(masked):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(120, 3)).astype(np.float32)
    y = rng.normal(size=(140, 3)).astype(np.float32)
    xm, ym = _masks(rng, 120, 140, masked)
    jm = [None if v is None else jnp.asarray(v) for v in (xm, ym)]
    tm = [None if v is None else torch.from_numpy(v) for v in (xm, ym)]
    jix, jiy = jch.chamfer_correspondences(jnp.asarray(x), jnp.asarray(y), *jm, backend="xla")
    tix, tiy = tch.chamfer_correspondences(torch.from_numpy(x), torch.from_numpy(y), *tm)
    np.testing.assert_array_equal(tix.numpy(), np.asarray(jix))
    np.testing.assert_array_equal(tiy.numpy(), np.asarray(jiy))
    # stale indices on moved points: the projected loss and its gradient
    x2 = x + 0.05 * rng.normal(size=x.shape).astype(np.float32)
    jl, jg = jax.value_and_grad(
        lambda a: jch.chamfer_from_indices(a, jnp.asarray(y), jix, jiy, *jm))(jnp.asarray(x2))
    xt = torch.from_numpy(x2).requires_grad_(True)
    tl = tch.chamfer_from_indices(xt, torch.from_numpy(y), tix, tiy, *tm)
    (tg,) = torch.autograd.grad(tl, xt)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
