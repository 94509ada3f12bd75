"""Host-side (numpy) quaternion/pose helpers shared by the structure and
joints stages.  Kept in core so both can import without a package cycle;
the tensor equivalents live in core.se3 / core.rotations.

Copy of autourdf_tpu.core.quat_np (numpy and scipy only), kept here so the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def average_quaternions_np(quats: np.ndarray) -> np.ndarray:
    """Eigen-average (Markley) of (N, 4) wxyz quaternions, sign-invariant."""
    A = quats.T @ quats / len(quats)
    _, vecs = np.linalg.eigh(A)
    return vecs[:, -1]


def quat_to_matrix_np(q_wxyz: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation as ScipyRot

    q = np.asarray(q_wxyz, dtype=np.float64)
    return ScipyRot.from_quat(np.concatenate([q[1:], q[:1]])).as_matrix()


def pose_to_matrix_np(pos: np.ndarray, quat_wxyz: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_to_matrix_np(quat_wxyz)
    T[:3, 3] = pos
    return T


def mean_link_frame_np(coords: np.ndarray) -> np.ndarray:
    """(M, 7) member [xyz, quat] coords -> (4, 4) link frame
    (mean position + eigen-averaged quaternion)."""
    return pose_to_matrix_np(
        coords[:, :3].mean(0), average_quaternions_np(coords[:, 3:])
    )
