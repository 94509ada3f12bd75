"""SE(3) rigid-transform utilities in PyTorch (port of autourdf_tpu.core.se3)."""

from __future__ import annotations

import torch

from . import rotations as R


def make_transform(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4) homogeneous transform."""
    batch = torch.broadcast_shapes(rot.shape[:-2], trans.shape[:-1])
    rot = rot.expand(batch + (3, 3))
    trans = trans.expand(batch + (3,))
    top = torch.cat([rot, trans[..., :, None]], dim=-1)
    bottom = rot.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def rot_of(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def trans_of(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform (R^T, -R^T t)."""
    rt = rot_of(T).transpose(-1, -2)
    t = -(rt @ trans_of(T)[..., None])[..., 0]
    return make_transform(rt, t)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3)."""
    return pts @ rot_of(T).transpose(-1, -2) + trans_of(T)[..., None, :]


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def xyzquat_to_matrix(xq: torch.Tensor) -> torch.Tensor:
    """(..., 7) [x y z qw qx qy qz] -> (..., 4, 4)."""
    return make_transform(R.quat_to_matrix(xq[..., 3:]), xq[..., :3])


def matrix_to_xyzquat(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 7) [x y z qw qx qy qz]."""
    return torch.cat([trans_of(T), R.matrix_to_quat(rot_of(T))], dim=-1)


def xyzrpy_to_matrix(xyz: torch.Tensor, rpy: torch.Tensor) -> torch.Tensor:
    """Extrinsic xyz euler (scipy 'xyz' convention: Rz @ Ry @ Rx) -> transform."""
    rx = R._axis_rot(rpy[..., 0], 0)
    ry = R._axis_rot(rpy[..., 1], 1)
    rz = R._axis_rot(rpy[..., 2], 2)
    return make_transform((rz @ ry) @ rx, xyz)


def se3_log(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """SE(3) log: returns (rotvec (...,3), v (...,3)) with T = exp([w, v])."""
    w = R.matrix_to_rotvec(rot_of(T))
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    t = trans_of(T)
    half = 0.5 * theta
    small = theta < 1e-5
    cot_term = torch.where(
        small,
        torch.full_like(theta, 1.0 / 12.0),
        (1.0 - half * torch.cos(half) / torch.clamp_min(torch.sin(half), 1e-30))
        / torch.clamp_min(theta * theta, 1e-30),
    )
    wxt = torch.linalg.cross(w, t, dim=-1)
    wxwxt = torch.linalg.cross(w, wxt, dim=-1)
    v = t - 0.5 * wxt + cot_term * wxwxt
    return w, v


def screw_from_transform(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Screw decomposition ``(axis, angle, point)`` of a rigid transform
    (minimum-norm point on the axis; see autourdf_tpu.core.se3)."""
    w = R.matrix_to_rotvec(rot_of(T))
    angle = torch.linalg.norm(w, dim=-1)
    axis = w / torch.clamp_min(angle[..., None], 1e-12)
    t = trans_of(T)
    t_par = torch.sum(t * axis, dim=-1, keepdim=True) * axis
    t_perp = t - t_par
    half = 0.5 * angle[..., None]
    cot = torch.cos(half) / torch.clamp_min(torch.sin(half), 1e-12)
    p = 0.5 * t_perp + 0.5 * cot * torch.linalg.cross(axis, t_perp, dim=-1)
    return axis, angle, p


def average_quaternions(quats: torch.Tensor) -> torch.Tensor:
    """Eigen-average of quaternions (Markley et al.), batch over leading dims."""
    A = quats.transpose(-1, -2) @ quats / quats.shape[-2]
    _, vecs = torch.linalg.eigh(A)
    return vecs[..., :, -1]
