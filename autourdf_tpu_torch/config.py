"""Robot registry and pipeline configuration (copy of autourdf_tpu.config).

The port keeps its own copy so it imports nothing of the JAX package.  It
plays the role of the reference's parameters.json plus the argparse
globals duplicated across its entry points.  The registry is native Python
(typed, defaulted); an external parameters.json with the reference schema
can be loaded on top for drop-in compatibility.

Ground-truth URDF paths are relative to ``asset_root`` (env
AUTOURDF_ASSET_ROOT, default ``reference`` under the working directory) so
no robot assets need to live in this repo.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field

DEFAULT_ASSET_ROOT = os.environ.get("AUTOURDF_ASSET_ROOT", "reference")


@dataclass
class RobotConfig:
    name: str
    num_seg: int
    dof: int
    gt_urdf: str                       # relative to asset_root
    voxel_size: float = 0.003
    cam_dist: float = 1.5
    ori: tuple = (0.0, 0.0, 0.0)       # predicted-URDF base orientation (eval)
    sim_ori: tuple = (0.0, 0.0, 0.0)   # gt base orientation in sim
    collision_exclusion: bool = False
    excluded_pairs: list = field(default_factory=list)
    global_scale: float = 1.0

    def gt_path(self, asset_root: str | None = None) -> str:
        root = asset_root or DEFAULT_ASSET_ROOT
        return self.gt_urdf if os.path.isabs(self.gt_urdf) else os.path.join(root, self.gt_urdf)


_R = RobotConfig
# Values mirror the reference registry (parameters.json) one-to-one:
# num_seg, dof, voxel_size,
# cam_dist, ori (pred-URDF base euler for eval), sim_ori (gt base euler
# in sim), collision exclusions, gt URDF path.
ROBOTS: dict[str, RobotConfig] = {
    r.name: r
    for r in [
        _R("wx200_4", 15, 4, "Robot/interbotix_descriptions/urdf/wx200_real.urdf"),
        _R("wx200_5", 20, 5, "Robot/interbotix_descriptions/urdf/wx200_real.urdf"),
        _R("franka", 20, 6, "Robot/franka/franka_panda.urdf", voxel_size=0.005, cam_dist=2.5),
        _R("ur5", 20, 5, "Robot/ur_e_description/urdf/ur5e.urdf", voxel_size=0.005, cam_dist=2.5),
        _R("bolt", 30, 6, "Robot/bolt/bolt.urdf", voxel_size=0.003, cam_dist=2.5,
           sim_ori=(0.0, -0.785, 0.785)),
        _R("allegro", 30, 11,
           "Robot/allegro_hand_description/allegro_hand_description_left_angle.urdf",
           voxel_size=0.003, cam_dist=0.5, ori=(0.0, 0.0, -1.57),
           sim_ori=(0.0, -0.314, 0.785), collision_exclusion=True),
        _R("allegro_16", 35, 16,
           "Robot/allegro_hand_description/allegro_hand_description_left.urdf",
           voxel_size=0.003, cam_dist=0.5, ori=(0.0, 0.0, -1.57),
           sim_ori=(0.0, -0.314, 0.785), collision_exclusion=True),
        _R("solo8", 35, 8, "Robot/robot_properties_solo/resources/xacro/solo8.urdf",
           voxel_size=0.003, cam_dist=2.5),
        _R("solo12", 30, 12, "Robot/robot_properties_solo/resources/xacro/solo12.urdf",
           voxel_size=0.005, cam_dist=2.0),
        _R("nao", 35, 11, "Robot/nao/urdf/naov40.urdf", voxel_size=0.003, cam_dist=2.5),
        _R("pxs", 45, 18, "Robot/interbotix_xshexapod_descriptions/urdf/pxmark4s.urdf",
           voxel_size=0.003, cam_dist=1.0),
        _R("op3", 45, 13,
           "Robot/ROBOTIS-OP3-Common-master/op3_description/op3_description/robotis_op3.urdf",
           voxel_size=0.004, cam_dist=1.0, collision_exclusion=True,
           excluded_pairs=[
               ("l_hip_yaw_link", "l_hip_pitch_link"),
               ("r_hip_yaw_link", "r_hip_pitch_link"),
               ("l_knee_link", "l_ank_roll_link"),
               ("r_knee_link", "r_ank_roll_link"),
           ]),
        # Sapien articulated objects (1-2 DoF household items)
        _R("laptop", 10, 1, "Robot/Sapien/laptop/laptop.urdf", voxel_size=0.02,
           cam_dist=2.5, sim_ori=(0.0, -0.785, 0.785)),
        _R("dishwasher", 20, 1, "Robot/Sapien/dishwasher/dishwasher.urdf",
           voxel_size=0.02, cam_dist=4.0),
        _R("trashcan", 10, 1, "Robot/Sapien/trashcan/trashcan.urdf", voxel_size=0.02,
           cam_dist=4.0),
        _R("faucet", 50, 1, "Robot/Sapien/faucet/faucet.urdf", voxel_size=0.02,
           cam_dist=2.5),
        _R("storage", 40, 2, "Robot/Sapien/storage/storage.urdf", voxel_size=0.01,
           cam_dist=3.0),
        _R("toilet", 40, 1, "Robot/Sapien/toilet/toilet.urdf", voxel_size=0.02,
           cam_dist=4.0),
        # real-scan configs (flat data/raw/{robot}/ layout, ragged frames)
        _R("wx200_real_4", 20, 4, "Robot/interbotix_descriptions/urdf/wx200_real.urdf",
           cam_dist=1.2, ori=(1.57, 0.0, 0.0)),
        _R("wx200_real_5", 20, 5, "Robot/interbotix_descriptions/urdf/wx200_real.urdf",
           cam_dist=1.2, ori=(1.57, 0.0, 0.0)),
    ]
}


def load_parameters_json(path: str) -> None:
    """Overlay a reference-format parameters.json onto the registry."""
    with open(path) as f:
        params = json.load(f)
    for name, p in params.items():
        ROBOTS[name] = RobotConfig(
            name=name,
            num_seg=p["num_seg"],
            dof=p["dof"],
            gt_urdf=p["gt"],
            voxel_size=p.get("voxel_size", 0.003),
            cam_dist=p.get("cam_dist", 1.5),
            ori=tuple(p.get("ori", (0, 0, 0))),
            sim_ori=tuple(p.get("sim_ori", (0, 0, 0))),
            collision_exclusion=p.get("collision_exclusion", False),
            excluded_pairs=p.get("excluded_pairs", []),
        )


def get_robot(name: str) -> RobotConfig:
    if name not in ROBOTS:
        raise KeyError(f"unknown robot {name!r}; known: {sorted(ROBOTS)}")
    return ROBOTS[name]


@dataclass
class PipelineConfig:
    """Shared knobs of the three pipeline stages (dataset/register/urdf)."""

    robot: str = "wx200_5"
    data_root: str = "data"
    step_size_deg: int = 4
    num_cameras: int = 20
    num_step: int = 10
    num_videos: int = 5
    num_points: int = 5000
    pix: int = 800
    noise: bool = True
    pose_noise: float = 0.01
    point_noise: float = 0.0005
    scale: float = 0.9
    seed: int = 2024

    # registration
    rot: str = "q"
    epochs: int = 300
    num_seg: int | None = None   # override of the registry's per-robot K
    seed_mode: str = "kmeans++"  # "kmeans++" (reference parity) | "fps"
    voxel_size: float | None = None  # override of the registry's mesh voxel
    # structure / urdf
    start_steps: int = 0
    end_steps: int = 10

    def num_segments(self) -> int:
        """Effective cluster count: CLI override else the robot registry."""
        return self.num_seg if self.num_seg else get_robot(self.robot).num_seg

    def voxel(self) -> float:
        """Effective mesh voxel size: CLI override else the registry."""
        return self.voxel_size or get_robot(self.robot).voxel_size

    def raw_dir(self) -> str:
        c = get_robot(self.robot)
        return os.path.join(
            self.data_root, "raw", self.robot,
            f"{self.step_size_deg}_deg_{self.num_cameras}_cams",
        )

    def part_dir(self) -> str:
        return os.path.join(
            self.data_root, "part", f"{self.robot}_{self.num_segments()}_seg",
            f"{self.step_size_deg}_deg_{self.num_cameras}_cams",
        )

    def mesh_dir(self) -> str:
        return os.path.join(
            self.data_root, "mesh", f"{self.robot}_{self.num_segments()}_seg",
            f"{self.step_size_deg}_deg_{self.num_cameras}_cams",
        )

    def urdf_path(self) -> str:
        return os.path.join(
            self.data_root, "urdf", f"{self.robot}_{self.num_segments()}_seg",
            f"{self.step_size_deg}_deg_{self.num_cameras}_cams.urdf",
        )

    def eval_dir(self) -> str:
        return os.path.join(
            self.data_root, "evaluation", f"{self.robot}_{self.num_segments()}_seg",
            f"{self.step_size_deg}_deg_{self.num_cameras}_cams",
        )

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
