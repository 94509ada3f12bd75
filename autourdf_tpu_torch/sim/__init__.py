from .capture import CameraRig, capture_cloud, sphere_camera_rig
from .collision import CollisionChecker
from .datagen import collect, generate_sequence
from .env import KinematicEnv
from .trajectory import angle_trajectory

__all__ = [
    "KinematicEnv",
    "CameraRig",
    "capture_cloud",
    "sphere_camera_rig",
    "CollisionChecker",
    "angle_trajectory",
    "collect",
    "generate_sequence",
]
