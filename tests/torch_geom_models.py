"""Plain PyTorch models of the three kernels of
``autourdf_tpu_torch/csrc/geom.cu`` (``fps_kernel``, ``icp_kabsch_kernel``,
``pca_normals_kernel``) and of their 3x3 solves, step for step: the same
fixed sweeps, the same rotations in the same order and every sum in the
kernel's order (for the Kabsch step, its cluster partition and reduction
tree), in float32 on whatever device the inputs are on.  Correctly rounded
``+ - * / sqrt`` on both sides (the kernels are built with -fmad=false and
IEEE division and square root), so on the same inputs a model and its
kernel can agree bit for bit.

PyTorch's square root on the CPU is not correctly rounded for every input
(its vectorised routine misses by an ulp now and then, in float32 and in
float64 alike), so the models take theirs from numpy, whose float32 root is
the correctly rounded one.

``tests/test_torch_geom.py`` holds the models against the JAX package on
the CPU; ``tests/test_torch_cuda.py`` holds the kernels against the models
on the card.  Imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from autourdf_tpu_torch.ops.knn import PAD_COORD

# csrc/geom.cu kKabschSweeps, kEigSweeps, kNewtonSchulz, kFpsCluster
KABSCH_SWEEPS = 6
EIG_SWEEPS = 6
NEWTON_SCHULZ = 4
FPS_CLUSTER_BLOCKS = 16
# csrc/geom.cu kIcpThreads, kIcpMaxCluster, kIcpBlockPoints
ICP_THREADS, ICP_MAX_CLUSTER, ICP_BLOCK_POINTS = 256, 8, 2048


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (as sqrtf on the card)."""
    return torch.from_numpy(np.sqrt(x.detach().cpu().numpy())).to(x.device)


def _jacobi_cs(a, b, g):
    """(c, s) of the rotation zeroing the coupling ``g`` of diagonal entries
    ``a`` (p) and ``b`` (q), as ``jacobi_cs``; the caller skips ``g == 0``."""
    z = (b - a) / (2.0 * g)
    t = torch.copysign(torch.ones_like(z), z) / (torch.abs(z) + _sqrt(1.0 + z * z))
    c = 1.0 / _sqrt(1.0 + t * t)
    return c, t * c


def _col_dot(B, p, q):
    return (B[:, 0, p] * B[:, 0, q] + B[:, 1, p] * B[:, 1, q]) + B[:, 2, p] * B[:, 2, q]


def _rotate_cols(M, p, q, c, s, on):
    """Columns p, q of ``M (B, 3, 3)`` <- (c m_p - s m_q, s m_p + c m_q)
    where ``on``."""
    mp, mq = M[:, :, p].clone(), M[:, :, q].clone()
    c, s, on = c[:, None], s[:, None], on[:, None]
    M[:, :, p] = torch.where(on, c * mp - s * mq, mp)
    M[:, :, q] = torch.where(on, s * mp + c * mq, mq)


def kabsch3_model(H: torch.Tensor, sweeps: int = KABSCH_SWEEPS) -> torch.Tensor:
    """``kabsch3`` (the 3x3 solve of ``icp_kabsch_kernel``): ``(B, 3, 3) ->
    (B, 3, 3)`` rotations
    ``V diag(1, 1, det(V U^T)) U^T`` of ``H = U S V^T``."""
    B = H.to(torch.float32).clone()
    n = B.shape[0]
    eye = torch.eye(3, dtype=torch.float32, device=B.device).repeat(n, 1, 1)
    V, U = eye.clone(), eye.clone()
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            a, b, g = _col_dot(B, p, p), _col_dot(B, q, q), _col_dot(B, p, q)
            on = g != 0
            c, s = _jacobi_cs(a, b, torch.where(on, g, torch.ones_like(g)))
            _rotate_cols(B, p, q, c, s, on)
            _rotate_cols(V, p, q, c, s, on)
    for p, q in ((0, 1), (0, 2), (1, 2)):          # larger norm first; negate the new q
        swap = (_col_dot(B, p, p) < _col_dot(B, q, q))[:, None]
        for M in (B, V):
            mp, mq = M[:, :, p].clone(), M[:, :, q].clone()
            M[:, :, p] = torch.where(swap, mq, mp)
            M[:, :, q] = torch.where(swap, -mp, mq)
    for p, q, col in ((0, 1, 0), (0, 2, 0), (1, 2, 1)):   # Givens QR of B = H V
        a, b = B[:, p, col].clone(), B[:, q, col].clone()
        r = _sqrt(a * a + b * b)
        on = r != 0
        safe = torch.where(on, r, torch.ones_like(r))
        c, s = (a / safe)[:, None], (b / safe)[:, None]
        bp, bq = B[:, p, :].clone(), B[:, q, :].clone()
        B[:, p, :] = torch.where(on[:, None], c * bp + s * bq, bp)
        B[:, q, :] = torch.where(on[:, None], c * bq - s * bp, bq)
        up, uq = U[:, :, p].clone(), U[:, :, q].clone()
        U[:, :, p] = torch.where(on[:, None], c * up + s * uq, up)
        U[:, :, q] = torch.where(on[:, None], c * uq - s * up, uq)
    # R[i][j] = (V[i][0] U[j][0] + V[i][1] U[j][1]) + V[i][2] U[j][2]
    prod = V[:, :, None, :] * U[:, None, :, :]
    return (prod[..., 0] + prod[..., 1]) + prod[..., 2]


def sym_eig3_min_model(C: torch.Tensor, sweeps: int = EIG_SWEEPS) -> torch.Tensor:
    """``sym_eig3_min`` (the 3x3 solve of ``pca_normals_kernel``): ``(N, 3,
    3)`` symmetric -> ``(N, 3)`` unit eigenvectors of the smallest
    eigenvalues."""
    A = C.to(torch.float32).clone()
    n = A.shape[0]
    V = torch.eye(3, dtype=torch.float32, device=A.device).repeat(n, 1, 1)
    for _ in range(sweeps):
        for p, q, r in ((0, 1, 2), (0, 2, 1), (1, 2, 0)):
            g = A[:, p, q].clone()
            on = g != 0
            c, s = _jacobi_cs(A[:, p, p], A[:, q, q], torch.where(on, g, torch.ones_like(g)))
            t = s / c
            app, aqq = A[:, p, p].clone(), A[:, q, q].clone()
            arp, arq = A[:, r, p].clone(), A[:, r, q].clone()
            new = {(p, p): app - t * g, (q, q): aqq + t * g, (p, q): torch.zeros_like(g),
                   (r, p): c * arp - s * arq, (r, q): s * arp + c * arq}
            for (i, j), v in new.items():
                A[:, i, j] = torch.where(on, v, A[:, i, j])
                A[:, j, i] = A[:, i, j]
            _rotate_cols(V, p, q, c, s, on)
    d = torch.diagonal(A, dim1=1, dim2=2)
    j = torch.zeros(n, dtype=torch.int64, device=A.device)
    for k in (1, 2):                                   # strictly smaller: the first on ties
        j = torch.where(d[:, k] < d.gather(1, j[:, None])[:, 0], k, j)
    v = V.gather(2, j[:, None, None].expand(n, 3, 1))[..., 0]
    inv = 1.0 / _sqrt((v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2])
    return v * inv[:, None]


def _sum3(a, b, c):
    """(a + b) + c: the kernels' sums of three products."""
    return (a + b) + c


def newton_schulz_model(R: torch.Tensor, steps: int = NEWTON_SCHULZ) -> torch.Tensor:
    """``newton_schulz``: ``R <- 1.5 R - 0.5 (R R^T) R``, each entry of a
    product summed in the order of its index."""
    for _ in range(steps):
        P = _sum3(*(R[:, :, None, k] * R[:, None, :, k] for k in range(3)))
        Q = _sum3(*(P[:, :, None, k] * R[:, None, k, :] for k in range(3)))
        R = 1.5 * R - 0.5 * Q
    return R


def icp_cluster_blocks(n: int) -> int:
    """``icp_cluster_blocks``: the blocks of an entry's cluster."""
    return max(1, min(ICP_MAX_CLUSTER, -(-n // ICP_BLOCK_POINTS)))


def icp_cluster_sums(v: torch.Tensor, blocks: int | None = None) -> torch.Tensor:
    """``v (B, n, S)`` summed over the points in ``icp_kabsch_kernel``'s
    order, ``(B, S)``: block r of ``blocks`` owns the points [r R, (r + 1)
    R), R = ceil(n / blocks), thread t the points t + 256 j of them, summed
    in order; in each warp lane l + off goes into lane l for off = 16, 8, 4,
    2, 1; the warps in order; the blocks in rank order.  A thread or block
    without points adds zeros (exact)."""
    B, n, S = v.shape
    c = blocks or icp_cluster_blocks(n)
    R = -(-n // c)
    J = -(-R // ICP_THREADS)
    flat = torch.zeros(B, c * R, S, dtype=v.dtype, device=v.device)
    flat[:, :n] = v
    tiles = torch.zeros(B, c, J * ICP_THREADS, S, dtype=v.dtype, device=v.device)
    tiles[:, :, :R] = flat.view(B, c, R, S)
    tiles = tiles.view(B, c, J, ICP_THREADS, S)
    acc = torch.zeros(B, c, ICP_THREADS, S, dtype=v.dtype, device=v.device)
    for j in range(J):
        acc = acc + tiles[:, :, j]
    lanes = acc.view(B, c, ICP_THREADS // 32, 32, S).clone()
    for off in (16, 8, 4, 2, 1):
        lanes[:, :, :, :off] = lanes[:, :, :, :off] + lanes[:, :, :, off:2 * off]
    block = torch.zeros(B, c, S, dtype=v.dtype, device=v.device)
    for w in range(ICP_THREADS // 32):
        block = block + lanes[:, :, w, 0]
    total = torch.zeros(B, S, dtype=v.dtype, device=v.device)
    for r in range(c):
        total = total + block[:, r]
    return total


def transform_model(source: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """``icp_kabsch_kernel``'s next moved cloud: ((x T[r][0] + y T[r][1]) +
    z T[r][2]) + T[r][3]."""
    rows = [_sum3(*(source[..., k] * T[:, None, r, k] for k in range(3))) + T[:, None, r, 3]
            for r in range(3)]
    return torch.stack(rows, dim=-1)


def icp_kabsch_model(source, moved, tgt, idx, d2, src_w, src_total, crit, T, fitness, rmse,
                     done, blocks: int | None = None):
    """``icp_kabsch_kernel`` (``ops/icp.py kabsch_step``), without writing
    into its inputs: ``(moved, T, fitness, rmse, done)`` after the step,
    ``moved`` from ``source`` under the frozen T.  ``blocks`` forces the
    cluster size (the kernel's comes from n)."""
    threshold, relative_rmse, relative_fitness = (c.to(torch.float32) for c in crit)
    B, n = moved.shape[:2]
    d = torch.gather(tgt, 1, idx[..., None].expand(B, n, 3))
    w = src_w * (_sqrt(torch.clamp_min(d2, 0.0)) < threshold).to(torch.float32)
    first = torch.cat([w[..., None], moved * w[..., None], d * w[..., None], (w * d2)[..., None]],
                      dim=-1)
    tot1 = icp_cluster_sums(first, blocks)
    wsum = torch.clamp_min(tot1[:, 0], 1e-12)[:, None]
    sm, dm = tot1[:, 1:4] / wsum, tot1[:, 4:7] / wsum
    sa = (moved - sm[:, None]) * w[..., None]
    dc = d - dm[:, None]
    H = icp_cluster_sums((sa[..., :, None] * dc[..., None, :]).reshape(B, n, 9), blocks)
    R = newton_schulz_model(kabsch3_model(H.view(B, 3, 3)))
    t = dm - _sum3(*(R[:, :, k] * sm[:, k, None] for k in range(3)))
    K = torch.cat([R, t[..., None]], dim=-1)                          # (B, 3, 4)
    rows = (_sum3(*(K[:, :, k, None] * T[:, None, k, :] for k in range(3)))
            + K[:, :, 3, None] * T[:, None, 3, :])
    T_new = torch.cat([rows, T[:, 3:]], dim=1)
    fit = tot1[:, 0] / src_total
    err = _sqrt(tot1[:, 7] / torch.clamp_min(tot1[:, 0], 1e-12))
    conv = ((torch.abs(fit - fitness) < relative_fitness * torch.clamp_min(fit, 1e-12))
            & (torch.abs(err - rmse) < relative_rmse * torch.clamp_min(err, 1e-12)))
    T_out = torch.where(done[:, None, None], T, T_new)
    return (transform_model(source, T_out), T_out, torch.where(done, fitness, fit),
            torch.where(done, rmse, err), done | conv)


# icp_step_inputs' kinds of entry whose H has rank 2 (a planar cloud) and
# rank 1 (a collinear one: its rotation about the line is free)
ICP_PLANAR, ICP_COLLINEAR = 6, 7


def icp_step_inputs(B: int, n: int, seed: int = 3):
    """One ICP step's inputs on the CPU, entry e of kind e % 8: 0 dense, 1
    masked (5% of the weights on, as ``--mlp_icp``'s clusters), 2 no
    inlier, 3 the cloud mirrored about its centre (a reflected H), 4 frozen
    (done), 5 an empty gate (every target a sentinel), 6 planar (z = 0: H
    of rank 2, as a flat link face gives), 7 collinear (y = z = 0: rank 1,
    a thin cluster).  The correspondences are the identity, d2 their
    distances.  Returns ``(args, state, kind)``: ``ops/icp.py
    kabsch_step(*args, *state)``, state = (T, fitness, rmse, done)."""
    rng = np.random.default_rng(seed)
    kind = np.arange(B) % 8
    src = rng.normal(scale=[0.12, 0.08, 0.05], size=(B, n, 3)) + rng.normal(0, 0.3, (B, 1, 3))
    src[kind == ICP_PLANAR, :, 2] = 0.0
    src[kind == ICP_COLLINEAR, :, 1:] = 0.0
    rot = ScipyRot.from_rotvec(rng.normal(0, 0.1, (B, 3))).as_matrix()
    tgt = np.einsum("bij,bnj->bni", rot, src) + rng.normal(0, 0.01, (B, 1, 3))
    centre = src.mean(1, keepdims=True)
    tgt[kind == 3] = ((src - centre) * [1.0, 1.0, -1.0] + centre)[kind == 3]
    tgt += rng.normal(0, 2e-3, tgt.shape)
    tgt[kind == 2] += 5.0
    tgt[kind == 5] = PAD_COORD
    w = np.ones((B, n), np.float32)
    w[kind == 1] = rng.random((int((kind == 1).sum()), n)) < 0.05
    T = np.tile(np.eye(4), (B, 1, 1))
    T[:, :3, :3] = ScipyRot.from_rotvec(rng.normal(0, 0.3, (B, 3))).as_matrix()
    T[:, :3, 3] = rng.normal(0, 0.2, (B, 3))
    source = np.einsum("bji,bnj->bni", T[:, :3, :3], src - T[:, None, :3, 3])
    src, tgt, source, T, w = (torch.from_numpy(a.astype(np.float32))
                              for a in (src, tgt, source, T, w))
    d2 = torch.sum((src - tgt) ** 2, dim=-1)
    crit = tuple(torch.tensor(v) for v in (0.25, 1e-6, 1e-6))
    args = (source, src, tgt, torch.arange(n).repeat(B, 1), d2, w,
            torch.clamp_min(w.sum(1), 1e-12), crit)
    state = (T, torch.full((B,), 0.5), torch.full((B,), 0.01), torch.from_numpy(kind == 4))
    return args, state, kind


def pca_normals_model(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pca_normals_kernel``: each neighbourhood's mean and the six sums of
    its centred covariance in the order of its neighbours, then
    ``sym_eig3_min_model`` and the flip towards +z."""
    nb = points.to(torch.float32)[idx]                                # (N, k, 3)
    k = idx.shape[1]
    mean = torch.zeros_like(nb[:, 0])
    for j in range(k):
        mean = mean + nb[:, j]
    c = nb - (mean / k)[:, None]
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    sums = torch.zeros(nb.shape[0], 6, dtype=torch.float32, device=nb.device)
    for j in range(k):
        sums = sums + torch.stack([c[:, j, a] * c[:, j, b] for a, b in pairs], dim=1)
    C = sums[:, [0, 1, 2, 1, 3, 4, 2, 4, 5]].view(-1, 3, 3)
    v = sym_eig3_min_model(C)
    return torch.where(v[:, 2:3] < 0, -v, v)


def fps_dist_kernel_order(points: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``fps_dist``: (x^2 + z^2) + y^2, the order of ``torch.sum((p - q) **
    2, dim=1)`` on the card."""
    d = (points - q) ** 2
    return (d[:, 0] + d[:, 2]) + d[:, 1]


def fps_model(points: torch.Tensor, k: int, mask: torch.Tensor | None = None,
              dist=fps_dist_kernel_order, blocks: int = FPS_CLUSTER_BLOCKS,
              capacity: int | None = None) -> torch.Tensor:
    """``fps_kernel``: block b of ``blocks`` owns the original indices
    ``[b R, (b + 1) R)``, ``R = ceil(n / blocks)``, and compacts its valid
    points stably (the first ``capacity`` into shared memory, the rest
    streamed from device memory; all of them where None).  Each step a
    block takes the largest key of its points, the running minimum's bits
    above the complement of the compact index, over its shared part and its
    overflow; its winner carries the minimum's bits above the complement of
    its original index, and the pick is the largest winner.  Step 0 is the
    same reduction with every minimum at +inf; with no valid point every
    pick is 0."""
    n = points.shape[0]
    dev = points.device
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
             else mask.to(device=dev, dtype=torch.bool))
    rng = -(-n // blocks)
    parts = []                                   # (original indices, points, minima)
    for b in range(blocks):
        idx = torch.arange(b * rng, min(n, (b + 1) * rng), device=dev)
        orig = idx[valid[idx]]
        parts.append([orig, points[orig].to(torch.float32),
                      torch.full((len(orig),), torch.inf, dtype=torch.float32, device=dev)])
    picks, q = [], None
    for _ in range(k):
        winners = []                             # (global key, coordinates)
        for part in parts:
            orig, work, mind = part
            count = len(orig)
            if count == 0:
                winners.append((0, None))
                continue
            if q is not None:
                mind = part[2] = torch.minimum(mind, dist(work, q))
            low = (~torch.arange(count, device=dev)) & 0xFFFFFFFF
            key = (mind.view(torch.int32).to(torch.int64) << 32) | low
            cap = count if capacity is None else capacity
            best = max(int(key[i:j].max()) for i, j in ((0, cap), (cap, count)) if j > i)
            j = (~best) & 0xFFFFFFFF
            winners.append((((best >> 32) << 32) | ((~int(orig[j])) & 0xFFFFFFFF), work[j]))
        pick, q = max(winners, key=lambda w: w[0])
        if pick == 0:
            return torch.zeros(k, dtype=torch.int64, device=dev)
        picks.append((~pick) & 0xFFFFFFFF)
    return torch.tensor(picks, dtype=torch.int64, device=dev)
