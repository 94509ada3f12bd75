"""Dual-quaternion SE(3) parameterization in PyTorch (port of
autourdf_tpu.core.dualquat).  A dual quaternion is stored as ``(..., 8)`` =
``[real(wxyz), dual(wxyz)]``; rotation q and translation t map to
``real = q``, ``dual = 0.5 * (0, t) * q``."""

from __future__ import annotations

import torch

from . import rotations as R
from . import se3


def from_quat_trans(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4) quat + (..., 3) translation -> (..., 8) dual quaternion."""
    t_quat = torch.cat([torch.zeros_like(t[..., :1]), t], dim=-1)
    dual = 0.5 * R.quat_multiply(t_quat, q)
    return torch.cat([q, dual], dim=-1)


def from_rot_trans(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return from_quat_trans(R.matrix_to_quat(rot), t)


def from_transform(T: torch.Tensor) -> torch.Tensor:
    return from_rot_trans(se3.rot_of(T), se3.trans_of(T))


def to_quat_trans(dq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    real, dual = dq[..., :4], dq[..., 4:]
    t = 2.0 * R.quat_multiply(dual, R.quat_invert(real))
    return real, t[..., 1:]


def to_rot_trans(dq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    q, t = to_quat_trans(dq)
    return R.quat_to_matrix(q), t


def to_transform(dq: torch.Tensor) -> torch.Tensor:
    rot, t = to_rot_trans(dq)
    return se3.make_transform(rot, t)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ar, ad = a[..., :4], a[..., 4:]
    br, bd = b[..., :4], b[..., 4:]
    real = R.quat_multiply(ar, br)
    dual = R.quat_multiply(ar, bd) + R.quat_multiply(ad, br)
    return torch.cat([real, dual], dim=-1)


def conjugate(dq: torch.Tensor) -> torch.Tensor:
    return torch.cat([R.quat_conjugate(dq[..., :4]), R.quat_conjugate(dq[..., 4:])], dim=-1)


def invert(dq: torch.Tensor) -> torch.Tensor:
    """Inverse of a (not necessarily unit) dual quaternion."""
    eps = torch.finfo(dq.dtype).eps
    real, dual = dq[..., :4], dq[..., 4:]
    n2 = torch.clamp_min(torch.sum(real * real, dim=-1, keepdim=True), eps)
    inv_real = R.quat_conjugate(real) / n2
    inv_dual = -R.quat_multiply(R.quat_multiply(inv_real, dual), inv_real)
    return torch.cat([inv_real, inv_dual], dim=-1)


def normalize(dq: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Project onto unit dual quaternions: |real|=1 and real . dual = 0."""
    real, dual = dq[..., :4], dq[..., 4:]
    n = torch.clamp_min(torch.linalg.norm(real, dim=-1, keepdim=True), eps)
    real = real / n
    dual = dual / n
    dual = dual - torch.sum(real * dual, dim=-1, keepdim=True) * real
    return torch.cat([real, dual], dim=-1)


def from_point(p: torch.Tensor) -> torch.Tensor:
    """Point -> dual quaternion (identity rotation + translation p)."""
    unit = torch.zeros(p.shape[:-1] + (4,), dtype=p.dtype, device=p.device)
    unit[..., 0] = 1.0
    return torch.cat([unit, torch.zeros_like(p[..., :1]), p], dim=-1)


def transform_points(dq: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply dual quaternion(s) (..., 8) to points (..., N, 3)."""
    rot, t = to_rot_trans(dq)
    return pts @ rot.transpose(-1, -2) + t[..., None, :]
