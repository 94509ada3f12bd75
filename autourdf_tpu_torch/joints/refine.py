"""Differentiable revolute-joint refinement (port of autourdf_tpu.joints.refine).

The screw-aggregation estimate (screw.py) inherits the noise of the
per-cluster rotation estimates: weakly constrained links (small or
near-symmetric point sets, e.g. a wrist) can end up with axes tens of
degrees off even when the registered *points* are accurate.  This module
re-fits each joint directly against those points with an explicit revolute
model

    world_t  =  T_parent(t) . Rot(axis, origin, theta_t) . X_child

with the axis direction, origin and per-frame joint angles as free
parameters, optimised by Adam against the masked symmetric Chamfer distance
to the observed child-link clouds.  The screw estimate is the
initialisation.

Where the JAX module maps the Chamfer over the T steps with ``vmap`` and
iterates under ``lax.scan``, here the T steps are one batched Chamfer call
and the loop is a Python loop whose state stays in tensors: nothing is read
back from the device until the fit ends.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import rotations as R
from ..core import se3
from ..ops.chamfer import chamfer_distance
from .screw import JointEstimate


class RefineResult(NamedTuple):
    axis: torch.Tensor      # (3,) unit axis in the parent frame at step 0
    origin: torch.Tensor    # (3,) point on the axis in the parent frame
    thetas: torch.Tensor    # (T,) fitted joint angles (theta[0] == 0)
    loss: torch.Tensor      # Chamfer of the last step, before its update


def _rot_about_axis(u: torch.Tensor, o: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) rotation by ``theta (...)`` about the line through
    ``o (..., 3)`` with direction ``u (..., 3)``.

    ``u`` and ``o`` are expanded to the angles' shape first, so that each
    angle's ``o - rot @ o`` meets its own gradient before the batch is
    summed: at a zero angle (``rot`` exactly the identity) the origin then
    gets exactly no gradient, as in the JAX function, instead of the
    round-off of two separate sums over the batch."""
    u = u.expand(theta.shape + (3,))
    o = o.expand(theta.shape + (3,))
    rot = R.rotvec_to_matrix(u * theta[..., None])
    t = o - (rot @ o[..., None])[..., 0]
    return se3.make_transform(rot, t)


def adam_bias_corrections(step: int) -> tuple[float, float]:
    """``(1 - 0.9**t, 1 - 0.999**t)`` in float32, as the JAX optimisers
    compute them from a float32 step count.  The power is taken in float64
    and rounded: that gives XLA's float32 value at every step up to 1,200
    (float32 ``powf`` differs by an ulp at a sixth of them, which is a
    relative 3e-5 of ``1 - 0.999**t`` in the first steps)."""
    t = np.float64(step)
    return tuple(float(np.float32(1.0) - np.float32(np.float64(np.float32(b)) ** t))
                 for b in (0.9, 0.999))


def fit_revolute_joint(
    parent_T: torch.Tensor,   # (T, 4, 4) parent link world poses
    child_obs: torch.Tensor,  # (T, P, 3) observed child-link world clouds (padded)
    child_mask: torch.Tensor, # (T, P) validity
    u0: torch.Tensor,         # (3,) initial axis, parent frame
    o0: torch.Tensor,         # (3,) initial origin, parent frame
    theta0: torch.Tensor,     # (T,) initial angles
    steps: int = 200,
    lr: float = 2e-2,
    origin_reg: float = 1e-3,
) -> RefineResult:
    """Adam fit of one revolute joint; the loss of every step is one Chamfer
    call of batch T (step 0's child cloud, posed at every step, against each
    step's observation)."""
    T_steps = parent_T.shape[0]
    inv_p0 = se3.inverse(parent_T[0])
    x_c = se3.transform_points(inv_p0, child_obs[0])       # child points, parent frame
    x_mask = child_mask[0].expand(T_steps, -1)
    first = torch.arange(T_steps, device=theta0.device) == 0

    def unpack(p):
        u = p["u"] / torch.clamp_min(torch.linalg.norm(p["u"]), 1e-9)
        return u, p["o"], torch.where(first, 0.0, p["theta"])

    def loss_fn(p):
        u, o, theta = unpack(p)
        world = se3.transform_points(parent_T @ _rot_about_axis(u, o, theta), x_c)
        losses = chamfer_distance(world, child_obs, x_mask, child_mask, norm=1)
        return torch.mean(losses) + origin_reg * torch.sum((o - o0) ** 2)

    params = {"u": u0, "o": o0, "theta": theta0}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    loss = None
    for i in range(1, steps + 1):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(p)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        bc1, bc2 = adam_bias_corrections(i)
        with torch.no_grad():
            mu = {k: 0.9 * mu[k] + 0.1 * grads[k] for k in p}
            nu = {k: 0.999 * nu[k] + 0.001 * grads[k] * grads[k] for k in p}
            params = {k: params[k] - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + 1e-8)
                      for k in p}
    with torch.no_grad():
        u, o, theta = unpack(params)
    return RefineResult(u, o, theta, loss.detach() if loss is not None
                        else torch.tensor(float("inf")))


def child_world_clouds(cm, members: list[int], cap: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-step world clouds of a link's member clusters, padded to cap."""
    T_steps = cm.coords.shape[0]
    obs = np.zeros((T_steps, cap, 3), np.float32)
    mask = np.zeros((T_steps, cap), bool)
    for t in range(T_steps):
        pts = np.asarray(cm.cluster_points[t])
        labels = np.asarray(cm.cluster_labels[t])
        parts = []
        for m in members:
            sel = labels == m
            M = cm.matrices[t, m]
            parts.append(pts[sel] @ M[:3, :3].T + M[:3, 3])
        cloud = np.concatenate(parts, axis=0) if parts else np.zeros((0, 3))
        n = min(len(cloud), cap)
        obs[t, :n] = cloud[:n]
        mask[t, :n] = True
    return obs, mask


def parent_link_poses(cm, members: list[int]) -> np.ndarray:
    """(T, 4, 4) link frames (mean position + eigen-averaged quaternion, as
    structure/links.py)."""
    from ..structure.links import link_frame

    T_steps = cm.coords.shape[0]
    return np.stack([link_frame(cm, members, t) for t in range(T_steps)])


def refine_joints(
    joints: list[JointEstimate],
    links,
    cm,
    steps: int = 200,
    point_cap: int = 2048,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> list[JointEstimate]:
    """Refine every estimated joint against the first sequence's clouds on
    ``device``.

    Returns new JointEstimates with updated global_pos / global_axis (the
    fields the URDF writer consumes); the screw estimates initialise the
    fit.
    """
    from scipy.spatial.transform import Rotation as ScipyRot

    dev = torch.device(device)
    by_id = {l.id: l for l in links}
    out = []
    for j in joints:
        parent = by_id[j.parent_link]
        child = by_id[j.child_link]
        parent_T = parent_link_poses(cm, sorted(parent.cluster_idx)).astype(np.float32)
        obs, mask = child_world_clouds(cm, sorted(child.cluster_idx), point_cap)

        inv_p0 = np.linalg.inv(parent_T[0].astype(np.float64))
        u0 = inv_p0[:3, :3] @ (j.global_axis / max(np.linalg.norm(j.global_axis), 1e-12))
        o0 = inv_p0[:3, :3] @ j.global_pos[:3] + inv_p0[:3, 3]

        # initial per-step angles: child relative rotation projected on u0
        T_steps = obs.shape[0]
        theta0 = np.zeros(T_steps, np.float32)
        child_T = parent_link_poses(cm, sorted(child.cluster_idx))
        rel0 = inv_p0 @ child_T[0]
        for t in range(1, T_steps):
            rel_t = np.linalg.inv(parent_T[t].astype(np.float64)) @ child_T[t]
            d_rel = rel_t @ np.linalg.inv(rel0)
            rv = ScipyRot.from_matrix(d_rel[:3, :3]).as_rotvec()
            theta0[t] = float(rv @ u0)

        def tensor(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        res = fit_revolute_joint(tensor(parent_T), tensor(obs), tensor(mask, torch.bool),
                                 tensor(u0), tensor(o0), tensor(theta0), steps=steps)
        u = res.axis.cpu().numpy().astype(np.float64)
        o = res.origin.cpu().numpy().astype(np.float64)
        p0 = parent_T[0].astype(np.float64)
        if verbose:
            print(f"[refine] joint {j.parent_link}->{j.child_link}: "
                  f"chamfer {float(res.loss):.5f}")
        out.append(
            JointEstimate(
                parent_link=j.parent_link,
                child_link=j.child_link,
                local_axis=u,
                local_pos=np.concatenate([o, [1.0]]),
                global_pos=p0[:3, :3] @ o + p0[:3, 3],
                global_axis=p0[:3, :3] @ u,
            )
        )
    return out
