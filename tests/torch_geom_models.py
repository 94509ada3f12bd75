"""Plain PyTorch models of the three kernels of
``autourdf_tpu_torch/csrc/geom.cu``, step for step: the same fixed sweeps,
the same rotations in the same order and every sum in the kernel's order,
in float32 on whatever device the inputs are on.  Correctly rounded
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

# csrc/geom.cu kKabschSweeps, kEigSweeps, kFpsCluster
KABSCH_SWEEPS = 6
EIG_SWEEPS = 6
FPS_CLUSTER_BLOCKS = 16


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
    """``kabsch3_kernel``: ``(B, 3, 3) -> (B, 3, 3)`` rotations
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
    """``sym_eig3_min_kernel``: ``(N, 3, 3)`` symmetric -> ``(N, 3)`` unit
    eigenvectors of the smallest eigenvalues."""
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
