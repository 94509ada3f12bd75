"""Point-to-point ICP (port of autourdf_tpu.ops.icp; Open3D
``registration_icp`` semantics), batched.

Used for the masked per-cluster refinement of ``register --mlp_icp``, for
the per-link canonical-frame refinement and the chain fit's polish of the
``urdf`` stage and for the evaluation's re-simulation alignment.  Each
iteration is one launch of the nearest-neighbour kernel for the whole batch
(ops/knn.py ``nn_search``) and, on the card, one launch of
``icp_kabsch_kernel`` (``csrc/geom.cu``) for everything after it:
correspondence-distance gating, the weighted Kabsch (means, centred
cross-covariance, rotation, Newton-Schulz), fitness, RMSE, the convergence
freeze matching Open3D's relative fitness/RMSE criteria, and the next
iteration's moved cloud.  On the CPU ``_kabsch_step_plain`` does the same in
plain PyTorch.  Where the JAX module maps one ICP over clusters with
``vmap`` and iterates under ``lax.scan`` in one compiled program, here the
batch axis is written out and the loop runs as one device program
(``utils/programs.py``: a CUDA graph on the card) keyed by the shapes and
the iteration count; the threshold and the relative criteria go in as 0-d
tensors, which the kernel reads from device memory, so one capture serves
every threshold (the chain fit's polish works one out for each link).
``eager=True`` runs the same loop as plain Python, the reference the program
is held against.  Nothing is read back from the device between iterations.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import programs
from . import _cuda
from .chamfer import _gather_points
from .knn import PAD_COORD, nn_search


class ICPResult(NamedTuple):
    transform: torch.Tensor  # (..., 4, 4) source -> target (includes init)
    fitness: torch.Tensor    # (...) fraction of source points with a gated match
    rmse: torch.Tensor       # (...) inlier RMSE


def _orthonormalize(R: torch.Tensor, steps: int = 4) -> torch.Tensor:
    """Project near-rotations ``(..., 3, 3)`` onto SO(3) by the Newton-Schulz
    polar iteration ``X <- 1.5 X - 0.5 X X^T X``: quadratic convergence to
    the orthogonal polar factor, determinant sign preserved (so the SVD's
    reflection handling survives).  Keeps a rotation composed over many ICP
    iterations from shrinking when the SVD factors are orthogonal only to
    fp32 iteration accuracy."""
    for _ in range(steps):
        R = 1.5 * R - 0.5 * (R @ R.transpose(-1, -2) @ R)
    return R


def _kabsch_rotation_plain(H: torch.Tensor) -> torch.Tensor:
    """``V diag(1, 1, det(V U^T)) U^T`` of ``H = U S V^T``, ``(B, 3, 3) ->
    (B, 3, 3)``: the least-squares rotations of cross-covariances (the
    reflection on the smallest singular value)."""
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    D = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1))
    return V @ D @ Ut


def _kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares rigid transforms src -> dst,
    ``(B, N, 3) x (B, N, 3) x (B, N) -> (B, 4, 4)``."""
    wsum = torch.clamp_min(torch.sum(w, dim=1), 1e-12)[:, None]
    ws = w[..., None]
    src_mean = torch.sum(src * ws, dim=1) / wsum
    dst_mean = torch.sum(dst * ws, dim=1) / wsum
    sc = src - src_mean[:, None, :]
    dc = dst - dst_mean[:, None, :]
    H = torch.einsum("bni,bnj->bij", sc * ws, dc)
    rot = _orthonormalize(_kabsch_rotation_plain(H))
    t = dst_mean - (rot @ src_mean[..., None])[..., 0]
    T = torch.eye(4, dtype=src.dtype, device=src.device).repeat(src.shape[0], 1, 1)
    T[:, :3, :3] = rot
    T[:, :3, 3] = t
    return T


def _transform(source: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """``source (B, N, 3)`` moved by ``T (B, 4, 4)``."""
    return source @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]


def _kabsch_step_plain(source, moved, tgt, idx, d2, src_w, src_total, crit, T, fitness, rmse,
                       done) -> torch.Tensor:
    """Plain version of ``icp_kabsch_kernel``: the rest of one ICP iteration
    after the search ``d2, idx = nn_search(moved, tgt)``.  Gates the matches
    at the threshold, fits the weighted Kabsch transform, composes it onto
    ``T`` and updates ``T``, ``fitness``, ``rmse`` and ``done`` in place under
    the convergence freeze; returns the next iteration's moved cloud."""
    threshold, relative_rmse, relative_fitness = crit
    dist = torch.sqrt(torch.clamp_min(d2, 0.0))
    w = src_w * (dist < threshold)
    T_new = _kabsch(moved, _gather_points(tgt, idx), w) @ T
    w_sum = torch.sum(w, dim=1)
    fit_new = w_sum / src_total
    rmse_new = torch.sqrt(torch.sum(w * d2, dim=1) / torch.clamp_min(w_sum, 1e-12))
    conv = ((torch.abs(fit_new - fitness) < relative_fitness * torch.clamp_min(fit_new, 1e-12))
            & (torch.abs(rmse_new - rmse) < relative_rmse * torch.clamp_min(rmse_new, 1e-12)))
    T.copy_(torch.where(done[:, None, None], T, T_new))
    fitness.copy_(torch.where(done, fitness, fit_new))
    rmse.copy_(torch.where(done, rmse, rmse_new))
    done |= conv
    return _transform(source, T)


# icp_kabsch_kernel's launch (csrc/geom.cu kIcpBlockPoints, kIcpMaxCluster):
# ceil(n / BLOCK_POINTS) blocks a cluster, at most MAX_CLUSTER_BLOCKS
BLOCK_POINTS = 2048
MAX_CLUSTER_BLOCKS = 8


def cluster_blocks(n: int) -> int:
    """The blocks of ``icp_kabsch_kernel``'s cluster for entries of ``n``
    points (a partition fixed by ``n`` alone)."""
    return min(max(-(-n // BLOCK_POINTS), 1), MAX_CLUSTER_BLOCKS)


class IcpKabschSetup(NamedTuple):
    """What ``geom_icp_kabsch_setup`` reports for a device: the clusters of
    1, ..., 8 blocks the card holds at once, and the kernel's registers and
    local (spilled) bytes a thread."""
    max_clusters: tuple
    registers: int
    local_bytes: int


# device index -> its setup, made once before the device's first launch
_setups: dict[int, IcpKabschSetup] = {}


def cluster_setup(device: torch.device) -> IcpKabschSetup:
    """Check once a device, before its first launch of ``icp_kabsch_kernel``,
    that the card holds the kernel's clusters of every size it launches
    (1 to 8 blocks, portable: no attribute to set); raises if it cannot
    (there is no other launch shape)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    setup = _setups.get(index)
    if setup is None:
        lib = _cuda.library("geom")
        clusters = (ctypes.c_int * MAX_CLUSTER_BLOCKS)()
        regs, local = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            err = lib.geom_icp_kabsch_setup(ctypes.addressof(clusters), ctypes.addressof(regs),
                                            ctypes.addressof(local))
        _cuda.check(err, "icp_kabsch_kernel set-up")
        setup = _setups[index] = IcpKabschSetup(tuple(clusters), regs.value, local.value)
        if min(setup.max_clusters) < 1:
            raise RuntimeError(f"icp_kabsch_kernel: the device cannot hold its clusters ({setup})")
    return setup


def _kabsch_step_cuda(source, moved, tgt, idx, d2, src_w, src_total, crit, T, fitness, rmse,
                      done) -> torch.Tensor:
    """Replaces the JAX module's ``_kabsch`` and the rest of its scan
    ``step`` (autourdf_tpu/ops/icp.py:50, :102-121), which the plain step
    runs as some seventy small kernels with ``torch.linalg.svd`` and ``det``
    reading back to the host: one launch, one cluster an entry; the next
    moved cloud is written into ``moved``'s buffer (csrc/geom.cu)."""
    B, N = moved.shape[:2]
    M = tgt.shape[1]
    floats = (source, moved, tgt, d2, src_w, src_total, *crit, T, fitness, rmse)
    if any(t.dtype != torch.float32 for t in floats) or idx.dtype != torch.int64 \
            or done.dtype != torch.bool:
        raise TypeError("icp_kabsch_kernel takes float32 clouds, weights and state, int64 "
                        "indices and a bool done")
    if source.shape != (B, N, 3) or idx.shape != (B, N) or d2.shape != (B, N) \
            or src_w.shape != (B, N) or tgt.shape != (B, M, 3) or T.shape != (B, 4, 4) \
            or any(t.shape != (B,) for t in (src_total, fitness, rmse, done)) \
            or any(c.numel() != 1 for c in crit):
        raise ValueError(f"icp_kabsch_kernel: inconsistent shapes for B={B}, N={N}, M={M}")
    if any(t.device != moved.device for t in (source, tgt, idx, d2, src_w, src_total, *crit, T,
                                              fitness, rmse, done)):
        raise ValueError(f"icp_kabsch_kernel: every input must lie on {moved.device}, as moved")
    if not all(t.is_contiguous() for t in (moved, T, fitness, rmse, done)):
        raise ValueError("icp_kabsch_kernel writes moved, T, fitness, rmse and done in place: "
                         "they must be contiguous")
    cluster_setup(moved.device)
    source, tgt, idx, d2, src_w, src_total = (
        t.contiguous() for t in (source, tgt, idx, d2, src_w, src_total))
    threshold, relative_rmse, relative_fitness = (c.contiguous() for c in crit)
    lib = _cuda.library("geom")
    err = _cuda.launch(
        lib.geom_icp_kabsch_launch, moved, source.data_ptr(), moved.data_ptr(), tgt.data_ptr(),
        idx.data_ptr(), d2.data_ptr(), src_w.data_ptr(), src_total.data_ptr(),
        threshold.data_ptr(), relative_rmse.data_ptr(), relative_fitness.data_ptr(),
        T.data_ptr(), fitness.data_ptr(), rmse.data_ptr(), done.data_ptr(), B, N, M,
        _cuda.stream(moved))
    _cuda.check(err, "icp_kabsch_kernel launch")
    _cuda.launch_counts["icp_kabsch"] += 1
    return moved


def kabsch_step(source, moved, tgt, idx, d2, src_w, src_total, crit, T, fitness, rmse,
                done) -> torch.Tensor:
    """One ICP iteration after the search (see ``_kabsch_step_plain``):
    ``T``, ``fitness``, ``rmse`` and ``done`` updated in place, the next
    moved cloud returned.  The kernel on CUDA tensors (which writes it into
    ``moved``), the plain version on CPU tensors."""
    if moved.is_cuda:
        return _kabsch_step_cuda(source, moved, tgt, idx, d2, src_w, src_total, crit, T,
                                 fitness, rmse, done)
    if moved.device.type != "cpu":
        raise ValueError(f"unsupported device {moved.device}")
    return _kabsch_step_plain(source, moved, tgt, idx, d2, src_w, src_total, crit, T, fitness,
                              rmse, done)


def _icp_loop(source, target, T, source_mask, target_mask, crit, max_iterations: int):
    """The ICP iterations on a batch: ``(T, fitness, rmse)``.  ``crit`` is
    ``(threshold, relative_rmse, relative_fitness)`` as 0-d tensors."""
    B, dev, dt = source.shape[0], source.device, source.dtype
    tgt = (target if target_mask is None
           else torch.where(target_mask[..., None], target, PAD_COORD))
    src_w = (torch.ones(source.shape[:2], dtype=dt, device=dev) if source_mask is None
             else source_mask.to(dt))
    src_total = torch.clamp_min(torch.sum(src_w, dim=1), 1e-12)

    moved = _transform(source, T)
    T = T.clone(memory_format=torch.contiguous_format)
    fitness = torch.full((B,), -1.0, dtype=dt, device=dev)
    rmse = torch.full((B,), -1.0, dtype=dt, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for _ in range(max_iterations):
        d2, idx = nn_search(moved, tgt, norm=2)
        moved = kabsch_step(source, moved, tgt, idx, d2, src_w, src_total, crit, T, fitness,
                            rmse, done)
    return T, fitness, rmse


def icp_point_to_point(
    source: torch.Tensor,           # (N, 3) or (B, N, 3)
    target: torch.Tensor,           # (M, 3) or (B, M, 3)
    init: torch.Tensor | None = None,
    max_iterations: int = 50,
    threshold: float = 1.0,         # max correspondence distance (o3d arg)
    source_mask: torch.Tensor | None = None,
    target_mask: torch.Tensor | None = None,
    relative_rmse: float = 1e-6,
    relative_fitness: float = 1e-6,
    eager: bool = False,
) -> ICPResult:
    """Open3D-semantics p2p ICP of one cloud pair or of a batch of pairs.

    ``max_iterations`` is a fixed bound; a batch entry that meets the
    relative criteria freezes, the others go on.  The iterations run as one
    program (``eager=False``) or as the plain loop (``eager=True``; also
    what a caller that is itself being captured into a program runs).
    """
    squeeze = source.dim() == 2
    if squeeze:
        source, target, init, source_mask, target_mask = (
            None if t is None else t[None]
            for t in (source, target, init, source_mask, target_mask))
    if init is None:
        init = torch.eye(4, dtype=source.dtype, device=source.device).repeat(source.shape[0], 1, 1)
    crit = tuple(torch.full((), float(v), dtype=source.dtype, device=source.device)
                 for v in (threshold, relative_rmse, relative_fitness))
    if eager:
        T, fitness, rmse = _icp_loop(source, target, init, source_mask, target_mask, crit,
                                     max_iterations)
    else:
        # the first capture of the family warms up on one iteration
        T, fitness, rmse = programs.clone(programs.run(
            ("icp", max_iterations), lambda *a: _icp_loop(*a, max_iterations),
            source, target, init, source_mask, target_mask, crit,
            warm=lambda *a: _icp_loop(*a, 1)))
    if squeeze:
        return ICPResult(T[0], fitness[0], rmse[0])
    return ICPResult(T, fitness, rmse)


def masked_icp_clusters(
    cluster_points: torch.Tensor,   # (N, 3) or (S, N, 3) local-frame points, flat
    labels: torch.Tensor,           # (N,) or (S, N) cluster ids
    matrices: torch.Tensor,         # (K, 4, 4) or (S, K, 4, 4) current cluster poses
    target: torch.Tensor,           # (M, 3) or (S, M, 3) next frame's cloud
    num_clusters: int,
    scale: float = 1.2,
    threshold: float = 1.0,
    max_iterations: int = 30,
) -> torch.Tensor:
    """Per-cluster AABB-masked ICP refinement of every cluster (of every
    sequence) as one batch of ``S * K`` ICPs, as the plain loop: it runs
    inside the registration's ICP-phase and frame-pair programs.

    For each cluster, the predicted world-frame AABB scaled by ``scale``
    gates the target points, then p2p ICP refines the cluster's 4x4 from
    its current estimate.  Returns the updated poses, shaped like
    ``matrices``.
    """
    squeeze = cluster_points.dim() == 2
    if squeeze:
        cluster_points, labels, matrices, target = (
            t[None] for t in (cluster_points, labels, matrices, target))
    S, N = cluster_points.shape[:2]
    K, M = num_clusters, target.shape[1]
    sel = labels[:, None, :] == torch.arange(K, device=labels.device)[None, :, None]  # (S, K, N)
    world = (cluster_points[:, None] @ matrices[..., :3, :3].transpose(-1, -2)
             + matrices[..., None, :3, 3])                                            # (S, K, N, 3)
    big = 1e9
    lo = torch.amin(torch.where(sel[..., None], world, big), dim=2)                   # (S, K, 3)
    hi = torch.amax(torch.where(sel[..., None], world, -big), dim=2)
    center = 0.5 * (lo + hi)
    half = 0.5 * scale * (hi - lo)
    tgt = target[:, None]                                                             # (S, 1, M, 3)
    in_box = torch.all((tgt > (center - half)[:, :, None]) & (tgt < (center + half)[:, :, None]),
                       dim=-1)                                                        # (S, K, M)
    res = icp_point_to_point(
        cluster_points[:, None].expand(S, K, N, 3).reshape(S * K, N, 3),
        tgt.expand(S, K, M, 3).reshape(S * K, M, 3),
        init=matrices.reshape(S * K, 4, 4),
        max_iterations=max_iterations,
        threshold=threshold,
        source_mask=sel.reshape(S * K, N),
        target_mask=in_box.reshape(S * K, M),
        eager=True,
    )
    out = res.transform.reshape(S, K, 4, 4)
    return out[0] if squeeze else out
