"""The CUDA kernels of the port against their plain PyTorch versions, on
the card.  Marked ``cuda``; they skip where no CUDA device is present.
Run them on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Distances must be bit-identical and indices equal (the kernels keep the
plain version's order of operations and never contract into FMAs).
"""

import numpy as np
import pytest
import torch

from autourdf_tpu_torch.ops import knn
from autourdf_tpu_torch.ops.chamfer import chamfer_distance

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU interpret mode")
    return torch.device("cuda")


def _clouds(S, N, M, ties, dev):
    rng = np.random.default_rng(N + M)
    x = rng.uniform(-0.3, 0.3, (S, N, 3)).astype(np.float32)
    y = rng.uniform(-0.3, 0.3, (S, M, 3)).astype(np.float32)
    if ties:
        y[:, M // 2:M // 2 + 20] = y[:, :20]
        x[:, N // 2:N // 2 + 20] = x[:, :20]
        x[:, -30:] = knn.PAD_COORD
        y[:, -20:] = knn.PAD_COORD
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("shape", [(1, 1, 1, False), (2, 65, 130, True), (3, 700, 333, True),
                                   (5, 4418, 4985, False)])
def test_kernels_match_plain_on_card(cuda, shape, norm):
    S, N, M, ties = shape
    x, y = _clouds(S, N, M, ties, cuda)
    before = dict(knn.launch_counts)
    got = knn.nn_search_bidirectional(x, y, norm)
    ref = knn._nn_bidir_plain(x, y, norm)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    gmin = knn.nn_min_bidirectional(x, y, norm)
    rmin = knn._nn_min_bidir_plain(x, y, norm)
    assert torch.equal(gmin[0], rmin[0]) and torch.equal(gmin[1], rmin[1])
    assert knn.launch_counts["nn_bidir"] == before["nn_bidir"] + 1
    assert knn.launch_counts["nn_min_bidir"] == before["nn_min_bidir"] + 1


def test_chamfer_grad_on_card_matches_cpu(cuda):
    # the same matched neighbours; index_add_ atomics reorder the sums
    x, y = _clouds(2, 700, 333, True, cuda)
    xm = torch.ones(2, 700, device=cuda)
    xm[:, -30:] = 0
    ym = torch.ones(2, 333, device=cuda)
    ym[:, -20:] = 0
    out = []
    for d in (cuda, torch.device("cpu")):
        xr = x.to(d).requires_grad_(True)
        loss = chamfer_distance(xr, y.to(d), xm.to(d), ym.to(d))
        (g,) = torch.autograd.grad(loss.sum(), xr)
        out.append((loss.detach().cpu(), g.cpu()))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-6, atol=0)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=1e-7)


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("shape", [(1, 1, 1, False), (2, 65, 130, True), (3, 700, 333, True),
                                   (100, 500, 480, True), (2, 25600, 2048, False)])
def test_nn_kernel_matches_plain_on_card(cuda, shape, norm):
    S, N, M, ties = shape
    x, y = _clouds(S, N, M, ties, cuda)
    before = knn.launch_counts["nn"]
    got = knn.nn_search(x, y, norm)
    ref = knn._nn_plain(x, y, norm)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert knn.launch_counts["nn"] == before + 1
    # every target at the sentinel: index 0 at a finite distance
    d, i = knn.nn_search(x, torch.full_like(y, knn.PAD_COORD), norm)
    assert bool(torch.isfinite(d).all()) and int(i.abs().max()) == 0


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("shape", [(1, 1, 1, False), (2, 65, 130, True), (3, 700, 333, True),
                                   (2, 4418, 4985, False)])
def test_accumulator_kernel_matches_plain_and_per_tile_on_card(cuda, shape, norm):
    S, N, M, ties = shape
    x, y = _clouds(S, N, M, ties, cuda)
    before = knn.launch_counts["nn_bidir_acc"]
    got = knn._nn_bidir_acc_cuda(x, y, norm)
    assert knn.launch_counts["nn_bidir_acc"] == before + 1
    for ref in (knn._nn_bidir_plain(x, y, norm), knn._nn_bidir_cuda(x, y, norm)):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("norm", [1, 2])
def test_accumulator_tie_rule_under_many_blocks(cuda, norm):
    """A column whose minimum is reached by rows in many tiles: the packed
    64-bit atomicMin must return the smallest row whatever order the blocks
    ran in.  Every 37th x row is one point (which is also y[5]), and some x
    rows coincide with y points (zero distances: +0.0, never -0.0)."""
    rng = np.random.default_rng(3)
    N, M = 4000, 600
    x = rng.uniform(-0.3, 0.3, (2, N, 3)).astype(np.float32)
    y = rng.uniform(-0.3, 0.3, (2, M, 3)).astype(np.float32)
    x[:, 11::37] = y[:, 5:6]
    x[:, 100:140] = y[:, 300:340]
    x[0, :, :] = x[0, :1, :]            # sequence 0: every x row is the same point
    x, y = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    for _ in range(5):
        got = knn._nn_bidir_acc_cuda(x, y, norm)
        ref = knn._nn_bidir_plain(x, y, norm)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert int(got[3][1, 5]) == 11 and bool((got[3][0] == 0).all())
        assert not bool(torch.signbit(got[2]).any())


def test_dispatch_by_scratch_size_on_card(cuda):
    x, y = _clouds(1, 20000, 20000, False, cuda)
    before = dict(knn.launch_counts)
    big = knn.nn_search_bidirectional(x, y, 1)
    assert knn.launch_counts["nn_bidir_acc"] == before["nn_bidir_acc"] + 1
    assert knn.launch_counts["nn_bidir"] == before["nn_bidir"]
    for a, b in zip(big, knn._nn_bidir_cuda(x, y, 1)):
        assert torch.equal(a, b)
    knn.nn_search_bidirectional(x[:, :5000], y[:, :5000], 1)
    assert knn.launch_counts["nn_bidir"] == before["nn_bidir"] + 2


def test_fps_and_icp_on_card_match_cpu(cuda):
    from autourdf_tpu_torch.ops.fps import farthest_point_sample
    from autourdf_tpu_torch.ops.icp import icp_point_to_point

    rng = np.random.default_rng(4)
    pts = rng.uniform(-0.3, 0.3, (3000, 3)).astype(np.float32)
    pts[1500:1600] = pts[:100]          # duplicated points: equal scores
    mask = torch.from_numpy(np.arange(3000) >= 7)
    p = torch.from_numpy(pts)
    assert torch.equal(farthest_point_sample(p.to(cuda), 20, mask.to(cuda)).cpu(),
                       farthest_point_sample(p, 20, mask))
    # one ICP step for a batch; entry 2 has no inlier (target out of reach)
    src = torch.from_numpy(rng.normal(scale=0.1, size=(3, 800, 3)).astype(np.float32))
    tgt = src + torch.tensor([0.01, -0.02, 0.015])
    tgt[2] += 5.0
    out = [icp_point_to_point(src.to(d), tgt.to(d), max_iterations=1, threshold=0.5)
           for d in (cuda, torch.device("cpu"))]
    # the same correspondences; the 3x3 SVD and sums differ in the last bits
    torch.testing.assert_close(out[0].transform.cpu(), out[1].transform, rtol=0, atol=1e-5)
    assert torch.equal(out[0].transform[2].cpu(), torch.eye(4))
