"""Point-to-point ICP (port of autourdf_tpu.ops.icp; Open3D
``registration_icp`` semantics), batched.

Used for the masked per-cluster refinement of ``register --mlp_icp``, for
the per-link canonical-frame refinement and the chain fit's polish of the
``urdf`` stage and for the evaluation's re-simulation alignment.  Each
iteration is one launch of the nearest-neighbour kernel for the whole batch
(ops/knn.py ``nn_search``), correspondence-distance gating, a weighted
Kabsch whose 3x3 rotations come from one launch of ``kabsch3_kernel``
(``csrc/geom.cu``) on the card, and a convergence freeze matching Open3D's
relative fitness/RMSE criteria.  Where the JAX module maps one ICP over
clusters with ``vmap`` and iterates under ``lax.scan`` in one compiled
program, here the batch axis is written out and the loop runs as one device
program (``utils/programs.py``: a CUDA graph on the card) keyed by the
shapes and the iteration count; the threshold and the relative criteria go
in as 0-d tensors, so one capture serves every threshold (the chain fit's
polish works one out for each link).  ``eager=True`` runs the same loop as
plain Python, the reference the program is held against.  Nothing is read
back from the device between iterations.
"""

from __future__ import annotations

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
    """Plain version of ``kabsch3_kernel``: ``V diag(1, 1, det(V U^T)) U^T``
    of ``H = U S V^T``, ``(B, 3, 3) -> (B, 3, 3)``."""
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    D = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1))
    return V @ D @ Ut


def _kabsch_rotation_cuda(H: torch.Tensor) -> torch.Tensor:
    """Replaces ``jnp.linalg.svd`` + ``det`` in the JAX module's ``_kabsch``
    (autourdf_tpu/ops/icp.py:50), which ``torch.linalg.svd`` and ``det``
    would do on the card only by reading the solver's status back to the
    host.  One thread a matrix: one-sided Jacobi sweeps, a sort and a
    Givens QR (csrc/geom.cu)."""
    if H.dtype != torch.float32:
        raise TypeError(f"kabsch3_kernel takes float32, got {H.dtype}")
    H = H.contiguous()
    R = torch.empty_like(H)
    lib = _cuda.library("geom")
    err = _cuda.launch(lib.geom_kabsch3_launch, H, H.data_ptr(), R.data_ptr(), H.shape[0],
                       _cuda.stream(H))
    _cuda.check(err, "kabsch3_kernel launch")
    _cuda.launch_counts["kabsch3"] += 1
    return R


def kabsch_rotation(H: torch.Tensor) -> torch.Tensor:
    """The least-squares rotations of cross-covariances ``H (B, 3, 3)``:
    ``V diag(1, 1, det(V U^T)) U^T`` of ``H = U S V^T`` (the reflection on
    the smallest singular value).  The kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if H.dim() != 3 or H.shape[1:] != (3, 3) or H.shape[0] == 0:
        raise ValueError(f"expected H (B >= 1, 3, 3), got {tuple(H.shape)}")
    if H.is_cuda:
        return _kabsch_rotation_cuda(H)
    if H.device.type != "cpu":
        raise ValueError(f"unsupported device {H.device}")
    return _kabsch_rotation_plain(H)


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
    rot = _orthonormalize(kabsch_rotation(H))
    t = dst_mean - (rot @ src_mean[..., None])[..., 0]
    T = torch.eye(4, dtype=src.dtype, device=src.device).repeat(src.shape[0], 1, 1)
    T[:, :3, :3] = rot
    T[:, :3, 3] = t
    return T


def _icp_loop(source, target, T, source_mask, target_mask, crit, max_iterations: int):
    """The ICP iterations on a batch: ``(T, fitness, rmse)``.  ``crit`` is
    ``(threshold, relative_rmse, relative_fitness)`` as 0-d tensors."""
    threshold, relative_rmse, relative_fitness = crit
    B, dev, dt = source.shape[0], source.device, source.dtype
    tgt = (target if target_mask is None
           else torch.where(target_mask[..., None], target, PAD_COORD))
    src_w = (torch.ones(source.shape[:2], dtype=dt, device=dev) if source_mask is None
             else source_mask.to(dt))
    src_total = torch.clamp_min(torch.sum(src_w, dim=1), 1e-12)

    fitness = torch.full((B,), -1.0, dtype=dt, device=dev)
    rmse = torch.full((B,), -1.0, dtype=dt, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for _ in range(max_iterations):
        moved = source @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
        d2, idx = nn_search(moved, tgt, norm=2)
        dist = torch.sqrt(torch.clamp_min(d2, 0.0))
        w = src_w * (dist < threshold)
        T_new = _kabsch(moved, _gather_points(tgt, idx), w) @ T
        w_sum = torch.sum(w, dim=1)
        fit_new = w_sum / src_total
        rmse_new = torch.sqrt(torch.sum(w * d2, dim=1) / torch.clamp_min(w_sum, 1e-12))
        conv = ((torch.abs(fit_new - fitness) < relative_fitness * torch.clamp_min(fit_new, 1e-12))
                & (torch.abs(rmse_new - rmse) < relative_rmse * torch.clamp_min(rmse_new, 1e-12)))
        T = torch.where(done[:, None, None], T, T_new)
        fitness = torch.where(done, fitness, fit_new)
        rmse = torch.where(done, rmse, rmse_new)
        done = done | conv
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
