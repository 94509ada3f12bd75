"""Dataset generation: collision-free multi-view point-cloud sequences
(port of autourdf_tpu.sim.datagen).

Rebuilds the reference collect() loop (reference/Sim/sim_data.py:465-532)
on the kinematic env: retry seeds until ``epochs`` collision-free
sequences exist, write the identical artifact tree

    data/raw/{robot}/{step}_deg_{cams}_cams/V{seed:04}/{t:04}/robot.ply
                                            + joint_cfg.txt

so every downstream stage (and the reference's own tooling) can consume it.
numpy's global stream is seeded and drawn in the JAX module's order, so
the camera rigs and trajectories are the JAX package's; the capture noise
comes from a ``torch.Generator`` seeded per sequence where the JAX module
seeds a ``jax.random`` key.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from .. import resolve_device
from ..config import PipelineConfig, get_robot
from ..io.ply import write_ply
from .env import KinematicEnv
from .trajectory import angle_trajectory


def generate_sequence(
    env: KinematicEnv,
    angles: np.ndarray,  # (T, dof)
    data_path: str | None,
    generator: torch.Generator | None,
    num_points: int = 5000,
    pix: int = 800,
    noise: bool = True,
    pose_noise: float = 0.01,
    point_noise: float = 0.0005,
) -> tuple[bool, list[np.ndarray]]:
    """Run one sequence; returns (collided, clouds).  Aborts on collision."""
    clouds = []
    for t, cmd in enumerate(angles):
        achieved = env.set_joint_positions(cmd)
        if env.check_collision():
            return True, clouds
        use_noise = noise and t != 0  # reference skips noise on frame 0
        cloud = env.capture(
            generator,
            num_points=num_points,
            width=pix,
            height=pix,
            pose_noise=pose_noise if use_noise else 0.0,
            point_noise=point_noise if use_noise else 0.0,
        )
        clouds.append(cloud)
        if data_path is not None:
            sub_path = os.path.join(data_path, f"{t:04}")
            os.makedirs(sub_path, exist_ok=True)
            write_ply(os.path.join(sub_path, "robot.ply"), cloud)
            with open(os.path.join(sub_path, "joint_cfg.txt"), "w") as f:
                for name, pos in achieved.items():
                    f.write(f"{name}:{pos:.6f}\n")
    return False, clouds


def collect(cfg: PipelineConfig, asset_root: str | None = None, ground: bool = False,
            epochs: int = 5, max_seed_tries: int = 200,
            device: str | torch.device = "cuda") -> list[str]:
    """Generate ``epochs`` collision-free sequences on ``device``; returns
    their dirs.  Sequences that collide are removed and the next seed tried."""
    dev = resolve_device(device)
    robot = get_robot(cfg.robot)
    np.random.seed(cfg.seed)  # reference seeds the global stream (sim_data.py:539)
    seq_dirs: list[str] = []
    seed = 0
    # per-sequence seeds depend on the run seed; the offset maps the default
    # seed 2024 to the historical 0..4 block
    seed_base = (cfg.seed - 2024) * 1000
    while len(seq_dirs) < epochs and seed < max_seed_tries:
        data_path = os.path.join(cfg.raw_dir(), f"V{seed:04}")
        os.makedirs(data_path, exist_ok=True)

        env = KinematicEnv.create(
            robot.gt_path(asset_root),
            base_orientation=robot.sim_ori,
            dof=robot.dof,
            radius=robot.cam_dist,
            num_cameras=cfg.num_cameras,
            ground=ground,
            asset_root=asset_root,
            camera_rng=np.random.default_rng(np.random.randint(2**31)),
            excluded_pairs=robot.excluded_pairs if robot.collision_exclusion else None,
            device=dev,
        )
        angles = angle_trajectory(
            num_step=cfg.num_step,
            step_size_deg=cfg.step_size_deg,
            dof=robot.dof,
            joint_limits_rad=env.joint_limits,
            scale=cfg.scale,
            seed=seed_base + seed,
        )
        generator = torch.Generator(device=dev).manual_seed(seed_base + seed)
        collided, _ = generate_sequence(
            env, angles, data_path, generator,
            num_points=cfg.num_points, pix=cfg.pix, noise=cfg.noise,
            pose_noise=cfg.pose_noise, point_noise=cfg.point_noise,
        )
        if collided:
            shutil.rmtree(data_path, ignore_errors=True)
        else:
            seq_dirs.append(data_path)
        seed += 1
    return seq_dirs
