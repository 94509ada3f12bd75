"""Parity of the port's one-directional search, its accumulator-kernel
plain version and the two Chamfer variants built on them
(autourdf_tpu_torch.ops.knn / .chamfer) with the JAX package on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions; the
JAX side runs ``_nn_pallas`` and ``_nn_bidir_pallas_acc`` in interpret mode
and ``_nn_xla``.  Distances agree to 1e-6 (fp32, the same elementwise
arithmetic; XLA may fuse the norm-2 products into FMAs, a last-bit
difference) and indices exactly, first index on ties.  Chamfer values and
gradients agree to 1e-6 relative / absolute: the matched neighbours are the
same, only the order of the mean's sum differs.
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
    if kind == "ragged_multi_tile":       # > 1 x-tile of the TPU kernel (tx=256)
        x, y = rng.normal(size=(700, 3)), rng.normal(size=(333, 3))
    elif kind == "sentinel_padded":
        x = np.concatenate([rng.normal(size=(90, 3)), np.full((38, 3), PAD)])
        y = np.concatenate([rng.normal(size=(70, 3)), np.full((58, 3), PAD)])
    elif kind == "all_sentinel_target":   # an AABB gate that leaves no target point
        x, y = rng.normal(size=(90, 3)), np.full((64, 3), PAD)
    else:                                 # "ties": duplicated points both ways
        x, y = rng.normal(size=(600, 3)), rng.normal(size=(250, 3))
        y[200:240] = y[0:40]
        x[550:600] = x[0:50]
        x[100:120] = y[10:30]
    return x.astype(np.float32), y.astype(np.float32)


CASES = ["ragged_multi_tile", "sentinel_padded", "all_sentinel_target", "ties"]


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_nn_search_parity(case, norm, backend):
    x, y = _clouds(case)
    jd, ji = jknn.nn_search(jnp.asarray(x), jnp.asarray(y), norm, backend)
    td, ti = tknn.nn_search(torch.from_numpy(x), torch.from_numpy(y), norm)
    assert ti.dtype == torch.int64 and td.dtype == torch.float32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if case == "all_sentinel_target":
        assert np.all(ti.numpy() == 0) and np.all(np.isfinite(td.numpy()))


@pytest.mark.parametrize("norm", [1, 2])
def test_nn_search_batch_equals_loop_and_rejects_bad_input(norm):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(3, 50, 3)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(3, 41, 3)).astype(np.float32))
    d, i = tknn.nn_search(x, y, norm)
    for s in range(3):
        ds, is_ = tknn.nn_search(x[s], y[s], norm)
        assert torch.equal(d[s], ds) and torch.equal(i[s], is_)
    with pytest.raises(ValueError):
        tknn.nn_search(x, y[:2], norm)
    with pytest.raises(ValueError):
        tknn.nn_search(x, y, 3)


@pytest.mark.parametrize("tx", [64, 256])
@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("case", ["ragged_multi_tile", "sentinel_padded", "ties"])
def test_bidirectional_plain_matches_accumulator_kernel(case, norm, tx):
    """The accumulator kernel computes the same function as the per-tile
    one, so the port holds both against one plain version: here against the
    TPU accumulator kernel itself, in interpret mode."""
    x, y = _clouds(case)
    jd = jknn._nn_bidir_pallas_acc(jnp.asarray(x), jnp.asarray(y), norm, tx, interpret=True)
    td = tknn._nn_bidir_plain(torch.from_numpy(x)[None], torch.from_numpy(y)[None], norm)
    for a, b in ((jd[0], td[0]), (jd[2], td[2])):
        np.testing.assert_allclose(b[0].numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(td[1][0].numpy(), np.asarray(jd[1]))
    np.testing.assert_array_equal(td[3][0].numpy(), np.asarray(jd[3]))


def test_accumulator_words_order_and_unpack():
    """The 64-bit word of the accumulator kernel, distance bits high and row
    index low: its integer order is (distance, then row), +0.0 is the
    smallest distance, and the wrapper's unpacking inverts the packing."""
    d = torch.tensor([[0.0, 0.0, 1e-30, 0.5, 0.5, 3e12, float("inf")]])
    r = torch.tensor([[3, 7, 0, 2, 19999, 5, 0x7FFFFFFF]])
    words = (d.view(torch.int32).to(torch.int64) << 32) | r
    assert torch.equal(torch.sort(words, dim=1).indices[0], torch.arange(7))
    assert int(words[0, -1]) == tknn._ACC_INIT
    dy, iy = tknn._unpack_columns(words)
    assert torch.equal(dy, d) and torch.equal(iy, r) and iy.dtype == torch.int64


def _masks(n, m, seed=5):
    rng = np.random.default_rng(seed)
    return rng.random(n) > 0.2, rng.random(m) > 0.3


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("norm", [1, 2])
def test_chamfer_directional_value_and_grad(norm, masked):
    x, y = _clouds("ties")
    xm, ym = _masks(len(x), len(y)) if masked else (None, None)
    jm = (None, None) if not masked else (jnp.asarray(xm), jnp.asarray(ym))
    jval, (jgx, jgy) = jax.value_and_grad(
        lambda a, b: jch.chamfer_directional(a, b, *jm, norm=norm, backend="xla"),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    tm = (None, None) if not masked else (torch.from_numpy(xm), torch.from_numpy(ym))
    tval = tch.chamfer_directional(tx, ty, *tm, norm=norm)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-6)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jgy), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("norm", [1, 2])
def test_chamfer_distance_trunc_value_and_grad(norm, masked):
    x, y = _clouds("ragged_multi_tile")
    y[:30] += 4.0                       # a far tail that the truncation clips
    xm, ym = _masks(len(x), len(y)) if masked else (None, None)
    jm = (None, None) if not masked else (jnp.asarray(xm), jnp.asarray(ym))
    jval, (jgx, jgy) = jax.value_and_grad(
        lambda a, b: jch.chamfer_distance_trunc(a, b, *jm, norm=norm, mult=3.0, backend="xla"),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    tm = (None, None) if not masked else (torch.from_numpy(xm), torch.from_numpy(ym))
    tval = tch.chamfer_distance_trunc(tx, ty, *tm, norm=norm, mult=3.0)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-6)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jgy), atol=1e-6)
    # the clip bites, and a huge multiple gives back the plain Chamfer
    plain = tch.chamfer_distance(torch.from_numpy(x), torch.from_numpy(y), *tm, norm=norm)
    assert float(tval.detach()) < float(plain)
    wide = tch.chamfer_distance_trunc(torch.from_numpy(x), torch.from_numpy(y), *tm, norm=norm,
                                      mult=1e9)
    np.testing.assert_allclose(float(wide), float(plain), rtol=1e-6)


def test_chamfer_variants_batch_equals_loop():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 60, 3)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(2, 45, 3)).astype(np.float32))
    xm = torch.from_numpy(rng.random((2, 60)) > 0.2)
    ym = torch.from_numpy(rng.random((2, 45)) > 0.2)
    for fn in (tch.chamfer_directional, tch.chamfer_distance_trunc):
        both = fn(x, y, xm, ym)
        for s in range(2):
            np.testing.assert_allclose(float(both[s]), float(fn(x[s], y[s], xm[s], ym[s])),
                                       rtol=1e-6)
