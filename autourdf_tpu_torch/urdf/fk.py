"""Forward kinematics over a RobotModel (host numpy).

Provides everything the reference extracted from PyBullet state:
- link world transforms at a joint configuration (getLinkState)
- joint world-frame axis lines for evaluation
  (reference/Sim/evaluation.py:115-201)

Copy of autourdf_tpu.urdf.fk (numpy and scipy only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.spatial.transform import Rotation as ScipyRot

from .parser import Joint, RobotModel


def _joint_motion(joint: Joint, q: float) -> np.ndarray:
    T = np.eye(4)
    if joint.type in ("revolute", "continuous"):
        axis = joint.axis / max(np.linalg.norm(joint.axis), 1e-12)
        T[:3, :3] = ScipyRot.from_rotvec(axis * q).as_matrix()
    elif joint.type == "prismatic":
        axis = joint.axis / max(np.linalg.norm(joint.axis), 1e-12)
        T[:3, 3] = axis * q
    return T


def joint_config_vector(model: RobotModel, config: dict[str, float]) -> np.ndarray:
    """Map {joint_name: angle} onto the movable-joint vector (zeros default)."""
    q = np.zeros(len(model.movable_joints))
    for i, j in enumerate(model.movable_joints):
        q[i] = config.get(j.name, 0.0)
    return q


def forward_kinematics(
    model: RobotModel,
    q: np.ndarray | dict[str, float] | None = None,
    base: np.ndarray | None = None,
) -> dict[str, np.ndarray]:
    """Link-name -> (4, 4) world transform at configuration ``q``.

    ``q`` indexes the movable joints in document order (PyBullet's order);
    a dict keyed by joint name is also accepted.
    """
    if isinstance(q, dict):
        q = joint_config_vector(model, q)
    if q is None:
        q = np.zeros(len(model.movable_joints))
    base = np.eye(4) if base is None else base

    movable_index = {j.name: i for i, j in enumerate(model.movable_joints)}
    world = {model.root: base.copy()}
    # iterate joints until all resolved (URDF trees are shallow; bounded loop)
    pending = list(model.joints)
    guard = 0
    while pending and guard < len(model.joints) + 2:
        nxt = []
        for j in pending:
            if j.parent in world:
                qi = q[movable_index[j.name]] if j.name in movable_index else 0.0
                world[j.child] = world[j.parent] @ j.origin @ _joint_motion(j, qi)
            else:
                nxt.append(j)
        pending = nxt
        guard += 1
    if pending:
        raise ValueError(
            f"unresolvable joints (disconnected tree?): {[j.name for j in pending]}"
        )
    return world


@dataclass
class JointWorldFrame:
    name: str
    position: np.ndarray  # (3,) a point on the joint axis, world frame
    axis: np.ndarray      # (3,) unit direction, world frame


def joint_world_frames(
    model: RobotModel,
    q: np.ndarray | dict[str, float] | None = None,
    base: np.ndarray | None = None,
    dof: int | None = None,
) -> list[JointWorldFrame]:
    """World-frame axis lines of the (first ``dof``) revolute joints."""
    world = forward_kinematics(model, q, base)
    out = []
    for j in model.revolute_joints[: dof if dof is not None else None]:
        parent_T = world[j.parent]
        joint_T = parent_T @ j.origin
        axis = joint_T[:3, :3] @ (j.axis / max(np.linalg.norm(j.axis), 1e-12))
        out.append(JointWorldFrame(j.name, joint_T[:3, 3].copy(), axis))
    return out


def link_points_world(
    model: RobotModel,
    link_samples: dict[str, np.ndarray],
    q: np.ndarray | dict[str, float] | None = None,
    base: np.ndarray | None = None,
) -> np.ndarray:
    """Pose pre-sampled per-link surface points into the world frame."""
    world = forward_kinematics(model, q, base)
    clouds = []
    for name, pts in link_samples.items():
        T = world[name]
        clouds.append(pts @ T[:3, :3].T + T[:3, 3])
    return np.concatenate(clouds, axis=0) if clouds else np.zeros((0, 3))


def sample_link_surfaces(
    model: RobotModel,
    points_per_unit_area: float | None = None,
    total_points: int = 200_000,
    prefer: str = "visual",
    rng: np.random.Generator | None = None,
) -> dict[str, np.ndarray]:
    """Area-proportional surface samples per link, in link-local frames."""
    from ..io.mesh_io import sample_surface

    rng = rng or np.random.default_rng(0)
    link_geoms = {}
    areas = {}
    for name, link in model.links.items():
        geoms = [g for g in link.geometry(prefer) if g.mesh is not None]
        if not geoms:
            continue
        link_geoms[name] = geoms
        areas[name] = sum(g.mesh.area for g in geoms)
    total_area = sum(areas.values())
    if total_area <= 0:
        return {}
    out = {}
    for name, geoms in link_geoms.items():
        n_link = max(1, int(round(total_points * areas[name] / total_area)))
        pieces = []
        for g in geoms:
            n_g = max(1, int(round(n_link * g.mesh.area / max(areas[name], 1e-12))))
            pts = sample_surface(g.mesh, n_g, rng)
            pieces.append(pts @ g.origin[:3, :3].T + g.origin[:3, 3])
        out[name] = np.concatenate(pieces, axis=0).astype(np.float32)
    return out
