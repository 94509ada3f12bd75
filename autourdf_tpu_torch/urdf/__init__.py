from .fk import (
    JointWorldFrame,
    forward_kinematics,
    joint_world_frames,
    link_points_world,
    sample_link_surfaces,
)
from .parser import Geometry, Joint, Link, RobotModel, load_urdf
from .writer import jet, link_transforms_at_step, write_urdf

__all__ = [
    "load_urdf",
    "RobotModel",
    "Link",
    "Joint",
    "Geometry",
    "forward_kinematics",
    "joint_world_frames",
    "JointWorldFrame",
    "link_points_world",
    "sample_link_surfaces",
    "write_urdf",
    "link_transforms_at_step",
    "jet",
]
