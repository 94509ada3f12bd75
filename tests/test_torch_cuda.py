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
