from .regmlp import MODES, PoseRegressor, params_from_jax, sin_encoding

__all__ = ["MODES", "PoseRegressor", "params_from_jax", "sin_encoding"]
