from .refine import RefineResult, fit_revolute_joint, refine_joints
from .screw import (
    JointCoherence,
    JointEstimate,
    cluster_pose_mean,
    estimate_joints_from_tree,
    filter_screws,
    joint_screw_coherence,
    optimize_joint_axis,
    screw_axes_from_pose_series,
)

__all__ = [
    "JointCoherence",
    "JointEstimate",
    "estimate_joints_from_tree",
    "filter_screws",
    "joint_screw_coherence",
    "optimize_joint_axis",
    "screw_axes_from_pose_series",
    "cluster_pose_mean",
    "refine_joints",
    "fit_revolute_joint",
    "RefineResult",
]
