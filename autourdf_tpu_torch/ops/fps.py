"""Farthest-point downsampling (port of autourdf_tpu.ops.fps; Open3D
``farthest_point_down_sample`` semantics).

Deterministic: seeds from point 0, or from the first valid point under a
mask, so fixed-capacity padded clouds can be sampled without compaction on
the host.  ``torch.argmax`` returns the first index among equal scores, as
``jnp.argmax`` does.

On a CUDA tensor the whole pick is one launch of ``fps_kernel``
(``csrc/geom.cu``), the counterpart of the JAX module's ``fori_loop``: one
cluster of 16 blocks on 16 SMs, each holding its share of the cloud in
shared memory, with one cluster barrier a step.  It reads nothing back to
the host, so it can sit inside a captured program.  On a CPU tensor the
plain version beside it runs the same k steps in Python.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _cuda

# csrc/geom.cu kFpsCluster, kFpsThreads
CLUSTER_BLOCKS, BLOCK_THREADS = 16, 1024


class ClusterSetup(NamedTuple):
    """What ``geom_fps_setup`` reports for a device: the clusters of
    ``CLUSTER_BLOCKS`` blocks the card holds at once, the dynamic shared
    bytes a block may take, and the kernel's registers and local (spilled)
    bytes a thread."""
    max_clusters: int
    shared_max: int
    registers: int
    local_bytes: int


# device index -> its setup, made once before the device's first launch
_setups: dict[int, ClusterSetup] = {}


def cluster_setup(device: torch.device) -> ClusterSetup:
    """Allow ``fps_kernel``'s non-portable cluster size and its shared
    memory on ``device``, once, and check that the card can hold such a
    cluster at all; raises if it cannot (there is no one-block fallback)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    setup = _setups.get(index)
    if setup is None:
        lib = _cuda.library("geom")
        vals = [ctypes.c_int(0) for _ in range(4)]
        with torch.cuda.device(index):
            err = lib.geom_fps_setup(*(ctypes.addressof(v) for v in vals))
        _cuda.check(err, "fps_kernel cluster set-up")
        setup = _setups[index] = ClusterSetup(*(v.value for v in vals))
        if setup.max_clusters < 1:
            raise RuntimeError(f"fps_kernel: the device holds no cluster of {CLUSTER_BLOCKS} "
                               f"blocks of {BLOCK_THREADS} threads ({setup})")
    return setup


def shared_plan(device: torch.device, n: int) -> tuple[int, int]:
    """``(points a block holds in shared memory, dynamic shared bytes a
    block)`` of a launch on ``n`` points; the rest of a block's range is
    streamed from device memory every step."""
    cluster_setup(device)
    cap = ctypes.c_int(0)
    nbytes = _cuda.library("geom").geom_fps_plan(n, ctypes.addressof(cap))
    return cap.value, nbytes


def _fps_plain(points: torch.Tensor, k: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``fps_kernel``: k steps of a running minimum squared
    distance and its first-index argmax."""
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


def _fps_cuda(points: torch.Tensor, k: int, mask: torch.Tensor | None) -> torch.Tensor:
    """Replaces the JAX module's ``fori_loop`` (autourdf_tpu/ops/fps.py:17).
    One cluster of 16 blocks walks the k steps, each block over its own
    range of the points; see csrc/geom.cu for the design."""
    if points.dtype != torch.float32:
        raise TypeError(f"fps_kernel takes float32 points, got {points.dtype}")
    points = points.contiguous()
    n = points.shape[0]
    valid = None if mask is None else mask.to(device=points.device, dtype=torch.bool).contiguous()
    if valid is not None and valid.shape != (n,):
        raise ValueError(f"mask of shape {tuple(valid.shape)} for {n} points")
    dev = points.device
    cluster_setup(dev)
    work = torch.empty((n, 4), dtype=torch.float32, device=dev)
    orig = torch.empty(n, dtype=torch.int32, device=dev)
    out = torch.empty(k, dtype=torch.int64, device=dev)
    lib = _cuda.library("geom")
    err = _cuda.launch(lib.geom_fps_launch, points, points.data_ptr(),
                       None if valid is None else valid.data_ptr(), n, k, work.data_ptr(),
                       orig.data_ptr(), out.data_ptr(), _cuda.stream(points))
    _cuda.check(err, "fps_kernel launch")
    _cuda.launch_counts["fps"] += 1
    return out


def farthest_point_sample(points: torch.Tensor, k: int,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """int64 indices ``(k,)`` of a farthest-point subset of ``points (N, 3)``.

    Masked-out points are never selected (their distance score is -inf).
    If fewer than ``k`` valid points exist, indices repeat the valid set;
    with none, every index is 0.
    """
    if points.dim() != 2 or points.shape[1] != 3 or points.shape[0] == 0 or k < 1:
        raise ValueError(f"expected points (N >= 1, 3) and k >= 1, got {tuple(points.shape)}, "
                         f"k={k}")
    if points.is_cuda:
        return _fps_cuda(points, k, mask)
    if points.device.type != "cpu":
        raise ValueError(f"unsupported device {points.device}")
    return _fps_plain(points, k, mask)
