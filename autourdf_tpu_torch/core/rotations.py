"""Rotation representation conversions in PyTorch.

Port of autourdf_tpu.core.rotations.  All quaternions follow the
``(w, x, y, z)`` real-first convention.  Every function is shape
polymorphic over leading batch dimensions and differentiable.  Matrix ->
quaternion keeps the branch-free Shepperd selection of the JAX version:
all four candidate solutions are computed and the best-conditioned one is
picked with an argmax (ties pick the first), with the 0.1 denominator floor
on the off-branch candidates.

Small 3x3 products are plain fp32 matmuls: the package turns TF32 off at
import, which is what ``precision="highest"`` pins on the JAX side.
"""

from __future__ import annotations

import torch


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions ``a * b``, both ``(..., 4)`` wxyz."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate ``(w, -x, -y, -z)`` of a ``(..., 4)`` quaternion."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_invert(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a (not necessarily unit) quaternion."""
    norm_sq = torch.sum(q * q, dim=-1, keepdim=True)
    return quat_conjugate(q) / torch.clamp_min(norm_sq, torch.finfo(q.dtype).tiny)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(n, eps)


def quat_standardize(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so the real part is non-negative (q and -q are the same rotation)."""
    return torch.where(q[..., :1] < 0, -q, q)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit-norm-insensitive quaternion -> rotation matrix, ``(..., 4) -> (..., 3, 3)``."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w >= 0), branch-free."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    q_abs_sq = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.clamp_min(q_abs_sq, 0.0))

    cand_w = torch.stack([q_abs_sq[..., 0], m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cand_x = torch.stack([m21 - m12, q_abs_sq[..., 1], m01 + m10, m02 + m20], dim=-1)
    cand_y = torch.stack([m02 - m20, m01 + m10, q_abs_sq[..., 2], m12 + m21], dim=-1)
    cand_z = torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs_sq[..., 3]], dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # (..., 4cand, 4)

    denom = 2.0 * torch.clamp_min(q_abs, 0.1)[..., None]  # floor avoids div-by-~0 off-branch
    cands = cands / denom

    best = torch.argmax(q_abs_sq, dim=-1)  # first index on ties, as jnp.argmax
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return quat_standardize(quat_normalize(q))


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v (..., 3)`` by quaternions ``q (..., 4)``."""
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return quat_multiply(quat_multiply(q, qv), quat_conjugate(q))[..., 1:]


# ---------------------------------------------------------------------------
# Euler angles (XYZ intrinsic, pytorch3d's "XYZ" convention)
# ---------------------------------------------------------------------------

def _axis_rot(angle: torch.Tensor, axis: int) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == 0:
        rows = [one, zero, zero, zero, c, -s, zero, s, c]
    elif axis == 1:
        rows = [c, zero, s, zero, one, zero, -s, zero, c]
    else:
        rows = [c, -s, zero, s, c, zero, zero, zero, one]
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


def euler_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """Intrinsic XYZ euler angles ``(..., 3)`` -> rotation matrix ``(..., 3, 3)``."""
    rx = _axis_rot(euler[..., 0], 0)
    ry = _axis_rot(euler[..., 1], 1)
    rz = _axis_rot(euler[..., 2], 2)
    return (rx @ ry) @ rz


def matrix_to_euler(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> intrinsic XYZ euler angles ``(..., 3)``."""
    b = torch.asin(torch.clamp(m[..., 0, 2], -1.0, 1.0))
    a = torch.atan2(-m[..., 1, 2], m[..., 2, 2])
    c = torch.atan2(-m[..., 0, 1], m[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


# ---------------------------------------------------------------------------
# 6D rotation representation (Zhou et al.)
# ---------------------------------------------------------------------------

def matrix_to_rot6d(m: torch.Tensor) -> torch.Tensor:
    """First two rows of the rotation matrix, flattened to ``(..., 6)``."""
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def rot6d_to_matrix(r6: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt the two 3-vectors back into a rotation matrix."""
    a1 = r6[..., 0:3]
    a2 = r6[..., 3:6]
    b1 = a1 / torch.clamp_min(torch.linalg.norm(a1, dim=-1, keepdim=True), 1e-12)
    a2_proj = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2_proj / torch.clamp_min(torch.linalg.norm(a2_proj, dim=-1, keepdim=True), 1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


# ---------------------------------------------------------------------------
# Axis-angle / rotation vectors
# ---------------------------------------------------------------------------

def matrix_to_rotvec(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector (axis * angle), via quaternion log."""
    return quat_to_rotvec(matrix_to_quat(m))


def quat_to_rotvec(q: torch.Tensor) -> torch.Tensor:
    q = quat_standardize(quat_normalize(q))
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    sin_half = _safe_norm(v)
    angle = 2.0 * torch.atan2(sin_half[..., 0], w)[..., None]
    # sinc-safe scale: angle / sin(angle/2); for tiny angles -> 2.
    scale = torch.where(sin_half > 1e-7, angle / sin_half, torch.full_like(sin_half, 2.0))
    return v * scale


def _safe_norm(x: torch.Tensor, dim=-1, keepdim=True, tiny: float = 1e-24) -> torch.Tensor:
    """sqrt(max(sum x^2, tiny)) — finite value AND gradient at x == 0."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp_min(sq, tiny))


def rotvec_to_quat(rv: torch.Tensor) -> torch.Tensor:
    angle = _safe_norm(rv)
    half = 0.5 * angle
    k = torch.where(angle > 1e-7, torch.sin(half) / angle, torch.full_like(angle, 0.5))
    return torch.cat([torch.cos(half), rv * k], dim=-1)


def rotvec_to_matrix(rv: torch.Tensor) -> torch.Tensor:
    return quat_to_matrix(rotvec_to_quat(rv))


def rotmat_geodesic_distance(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Angle of r1^T r2 in radians."""
    rel = r1.transpose(-1, -2) @ r2
    tr = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))


def rotvec_geodesic_distance(rv1: torch.Tensor, rv2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between two rotations given as rotation vectors."""
    q1, q2 = rotvec_to_quat(rv1), rotvec_to_quat(rv2)
    rel = quat_multiply(quat_conjugate(q1), q2)
    w = torch.clamp(torch.abs(rel[..., 0]), 0.0, 1.0)
    return 2.0 * torch.arccos(w)
