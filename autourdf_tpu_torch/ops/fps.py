"""Farthest-point downsampling (port of autourdf_tpu.ops.fps; Open3D
``farthest_point_down_sample`` semantics).

Deterministic: seeds from point 0, or from the first valid point under a
mask, so fixed-capacity padded clouds can be sampled without compaction on
the host.  ``torch.argmax`` returns the first index among equal scores, as
``jnp.argmax`` does.  The k-step loop keeps everything on the device: no
value is read back between steps.
"""

from __future__ import annotations

import torch


def farthest_point_sample(points: torch.Tensor, k: int,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """int64 indices ``(k,)`` of a farthest-point subset of ``points (N, 3)``.

    Masked-out points are never selected (their distance score is -inf).
    If fewer than ``k`` valid points exist, indices repeat the valid set.
    """
    valid = None if mask is None else mask.to(torch.bool)

    def score(d):
        return d if valid is None else torch.where(valid, d, -torch.inf)

    first = (torch.zeros((), dtype=torch.int64, device=points.device) if valid is None
             else torch.argmax(valid.to(torch.int8)))
    mind = torch.sum((points - points[first]) ** 2, dim=1)
    idxs = [first]
    for _ in range(1, k):
        nxt = torch.argmax(score(mind))
        idxs.append(nxt)
        mind = torch.minimum(mind, torch.sum((points - points[nxt]) ** 2, dim=1))
    return torch.stack(idxs)
