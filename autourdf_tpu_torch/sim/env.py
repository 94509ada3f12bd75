"""Kinematic simulation environment (port of autourdf_tpu.sim.env).

The reference uses PyBullet only as (a) a URDF loader, (b) a position
controller that settles at the commanded angles after 600 substeps, and
(c) a depth-camera renderer plus contact query
(reference/Sim/sim_data.py:15-218).  A position-controlled arm at steady
state IS its kinematic pose, so this env replaces the physics with exact
FK: commands are clamped to joint limits (what the motors converge to),
capture is the device z-buffer splat (``sim/capture.py``, on ``device``),
and collision is a sampled point-distance query between non-adjacent links
(host numpy).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..urdf.fk import forward_kinematics, sample_link_surfaces
from ..urdf.parser import RobotModel, load_urdf
from .capture import CameraRig, capture_cloud, sphere_camera_rig
from .collision import CollisionChecker


@dataclass
class KinematicEnv:
    model: RobotModel
    rig: CameraRig
    dof: int
    base: np.ndarray
    ground: bool = False
    collision_threshold: float = 0.0015
    excluded_pairs: list[tuple[str, str]] = field(default_factory=list)
    surface_points: int = 200_000
    prefer_geometry: str = "visual"
    device: torch.device = field(default_factory=lambda: resolve_device("cuda"))
    _link_samples: dict[str, np.ndarray] = field(default_factory=dict)
    _collision: CollisionChecker | None = None
    _current_q: dict[str, float] | None = None

    @classmethod
    def create(
        cls,
        urdf_path: str,
        base_position=(0, 0, 0),
        base_orientation=(0, 0, 0),
        dof: int = 5,
        radius: float = 1.5,
        num_cameras: int = 20,
        global_scale: float = 1.0,
        ground: bool = False,
        asset_root: str | None = None,
        camera_rng: np.random.Generator | None = None,
        surface_points: int = 200_000,
        excluded_pairs: list | None = None,
        prefer_geometry: str = "visual",
        device: str | torch.device = "cuda",
    ) -> "KinematicEnv":
        from scipy.spatial.transform import Rotation as ScipyRot

        dev = resolve_device(device)
        model = load_urdf(urdf_path, asset_root=asset_root, global_scale=global_scale)
        base = np.eye(4)
        base[:3, :3] = ScipyRot.from_euler("xyz", base_orientation).as_matrix()
        base[:3, 3] = base_position
        rig = sphere_camera_rig(
            radius, num_cameras, camera_rng or np.random.default_rng(0), device=dev
        )
        env = cls(
            model=model,
            rig=rig,
            dof=dof,
            base=base,
            ground=ground,
            excluded_pairs=[tuple(p) for p in (excluded_pairs or [])],
            surface_points=surface_points,
            prefer_geometry=prefer_geometry,
            device=dev,
        )
        env._link_samples = sample_link_surfaces(
            model, total_points=surface_points, prefer=prefer_geometry
        )
        env._collision = CollisionChecker(model, env._link_samples, env.excluded_pairs)
        # calibrate rest distances at the home pose (mid-limit for every
        # revolute joint — the pose non-dof joints are held at)
        home = {
            j.name: (min(j.lower, j.upper) + max(j.lower, j.upper)) / 2.0
            for j in model.revolute_joints
        }
        env._collision.calibrate(forward_kinematics(model, home, env.base))
        return env

    # -- joint control -------------------------------------------------------

    @property
    def dof_joints(self):
        return self.model.revolute_joints[: self.dof]

    @property
    def joint_limits(self) -> np.ndarray:
        """(dof, 2) limits with lower/upper possibly swapped, as in the URDF.

        Mirrors SimEnv.joint_limits (raw [lower, upper] from the file)."""
        return np.array([[j.lower, j.upper] for j in self.dof_joints])

    def set_joint_positions(self, commands: np.ndarray) -> dict[str, float]:
        """Command the dof joints; non-dof revolute joints hold midpoint.

        Returns achieved positions (commands clamped to limits — the steady
        state PyBullet's position controller converges to)."""
        achieved: dict[str, float] = {}
        for j, cmd in zip(self.dof_joints, commands):
            lo, hi = min(j.lower, j.upper), max(j.lower, j.upper)
            achieved[j.name] = float(np.clip(cmd, lo, hi))
        for j in self.model.revolute_joints[self.dof :]:
            lo, hi = min(j.lower, j.upper), max(j.lower, j.upper)
            achieved[j.name] = (lo + hi) / 2.0
        self._current_q = achieved
        return {n: achieved[n] for n in (jj.name for jj in self.dof_joints)}

    # -- state queries -------------------------------------------------------

    def link_transforms(self) -> dict[str, np.ndarray]:
        return forward_kinematics(self.model, self._current_q or {}, self.base)

    def posed_surface_points(self) -> np.ndarray:
        world = self.link_transforms()
        clouds = []
        for name, pts in self._link_samples.items():
            T = world[name]
            clouds.append(pts @ T[:3, :3].T.astype(np.float32) + T[:3, 3].astype(np.float32))
        return np.concatenate(clouds, axis=0)

    def check_collision(self) -> bool:
        """Self collision (non-adjacent link pairs) or floor contact."""
        world = self.link_transforms()
        if self._collision.self_collision(world, self.collision_threshold):
            return True
        if self.ground:
            pts = self.posed_surface_points()
            if np.any(pts[:, 2] < -1e-4):
                return True
        return False

    def capture(
        self,
        generator: torch.Generator | None = None,
        num_points: int = 5000,
        width: int = 400,
        height: int = 400,
        pose_noise: float = 0.0,
        point_noise: float = 0.0,
    ) -> np.ndarray:
        """One multi-camera capture of the current pose -> ``(num_points, 3)``
        float32; ``generator`` (on the env's device) draws the noise, if any."""
        pts = torch.from_numpy(self.posed_surface_points()).to(self.device)
        cloud, _ = capture_cloud(
            pts, self.rig, generator, width=width, height=height,
            num_points=num_points, pose_noise=pose_noise, point_noise=point_noise,
        )
        return cloud.cpu().numpy()
