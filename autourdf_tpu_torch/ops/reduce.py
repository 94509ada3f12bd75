"""Sums along the last dimension whose order of additions depends on the
row length only, not on how many rows are reduced together.

PyTorch's CUDA reduction shares its threads between the rows of a call: with
fewer rows, each row gets more threads and its additions are grouped
differently.  A batched loss summed that way changes in its last bits with
the batch a sequence is in, and 300 epochs of best-pose tracking turn that
into different poses (a data-parallel split of a registration, two
sequences a rank, parted from the four-sequence run by 1.1e-3 in a loss and
1,274 labels; H100 80GB HBM3, 700 W, ``chip_smoke.py`` [12d]).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Rows are summed in rounds of this many elements (the warp width): a round
# reduces each group of 32 with a fixed tree, whatever the number of groups.
GROUP = 32


def row_sums(v: torch.Tensor) -> torch.Tensor:
    """``v.sum(-1)`` in rounds of ``GROUP``: the rows are padded once with
    zeros (which add exactly) to a power of ``GROUP``, and each round sums
    groups of ``GROUP`` consecutive elements, so each row's result is the
    same whatever the leading dimensions hold."""
    n, width, rounds = v.shape[-1], 1, 0
    while width < n:
        width, rounds = width * GROUP, rounds + 1
    if width > n:
        v = F.pad(v, (0, width - n))
    for _ in range(rounds):
        v = v.reshape(v.shape[:-1] + (-1, GROUP)).sum(-1)
    return v[..., 0]
