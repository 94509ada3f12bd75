from . import dualquat, rotations, se3

__all__ = ["rotations", "se3", "dualquat"]
