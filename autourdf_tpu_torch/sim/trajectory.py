"""Joint-trajectory generation for data collection.

Behavioral rebuild of ``angle_list`` (reference/Sim/sim_data.py:372-430):
per joint, repeatedly sample a target inside scaled limits (rejecting
targets closer than 20% of the scaled range), walk toward it with a
randomized step size in [step, 2*step] degrees, concatenate until
``num_step`` frames exist.  Start pose is 50% of the scaled range — the
same for every seed, which is what lets all sequences share one frame-0
segmentation.

Copy of autourdf_tpu.sim.trajectory (numpy only): the same
``np.random.RandomState(seed)`` draws, so trajectories are equal.
"""

from __future__ import annotations

import numpy as np


def angle_trajectory(
    num_step: int,
    step_size_deg: float,
    dof: int,
    joint_limits_rad: np.ndarray,  # (dof, 2)
    scale: np.ndarray | float = 0.9,
    seed: int = 0,
    start_rate: float = 0.5,
    low_step_limit: float = 0.2,
) -> np.ndarray:
    """Return (num_step, dof) joint angles in radians."""
    rng = np.random.RandomState(seed)
    scale = np.broadcast_to(np.asarray(scale, dtype=np.float64), (dof,))
    limits_deg = np.asarray(joint_limits_rad) * 180.0 / np.pi
    scaled = limits_deg * scale[:, None]
    span = np.abs(scaled[:, 1] - scaled[:, 0])

    start = scaled[:, 0] + start_rate * (scaled[:, 1] - scaled[:, 0])
    cols = []
    for j in range(dof):
        vals: list[float] = []
        s = start[j]
        while len(vals) < num_step:
            while True:
                target = rng.rand() * (scaled[j, 1] - scaled[j, 0]) + scaled[j, 0]
                if abs(target - s) > low_step_limit * span[j]:
                    break
            step = step_size_deg * (1.0 + rng.rand())  # [step, 2*step)
            n = int(abs(target - s) / step) + 1
            direction = 1.0 if target > s else -1.0
            int_target = s + direction * step * n
            vals += list(np.linspace(s, int_target, n, endpoint=False))
            s = int_target
        cols.append(np.asarray(vals[:num_step]))
    return np.stack(cols, axis=1) * np.pi / 180.0
