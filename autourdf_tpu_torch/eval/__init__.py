from .joints_eval import JointComparison, compare_joints, joint_error
from .resim import load_offset, resim_chamfer

__all__ = [
    "compare_joints",
    "joint_error",
    "JointComparison",
    "resim_chamfer",
    "load_offset",
]
