"""Re-simulation Chamfer evaluation (port of autourdf_tpu.eval.resim).

Rebuilds evaluation() (reference/Sim/evaluation.py:228-381): load predicted
and ground-truth URDFs into two kinematic envs, command the same random
joint configurations (mapped through the direction map, inverse joint map,
and the gt start offsets), capture 10k-point clouds from both, ICP-align
pred onto gt, and record the Chamfer-L1 distances.  The captures run with
the noise off (nothing is drawn), the ICP on the one-directional search
kernel and the Chamfer on the min-only kernel, all on ``device``.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from .. import resolve_device
from ..io.ply import write_ply
from ..ops.chamfer import chamfer_distance
from ..ops.icp import icp_point_to_point
from ..sim.env import KinematicEnv


def resim_chamfer(
    pred_urdf_path: str,
    gt_urdf_path: str,
    dof: int,
    offset: np.ndarray,
    joint_map: np.ndarray,
    direction_map: list[int],
    save_path: str | None = None,
    sim_ori=(0, 0, 0),
    pred_ori=(0, 0, 0),
    radius: float = 1.5,
    num_cameras: int = 20,
    num_configs: int = 3,
    num_points: int = 10000,
    global_scale: float = 1.0,
    asset_root: str | None = None,
    icp_threshold: float = 0.01,
    rng: np.random.Generator | None = None,
    seed: int = 0,
    a_list: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, float, float]:
    """Returns (losses, mean, std) over ``num_configs`` random commands.

    ``a_list`` (num_configs, dof) overrides the random gt-frame commands."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(seed)
    if a_list is None:
        a_list = rng.random((num_configs, dof)) * 2.0 - 1.0  # [-1, 1] rad
    else:
        a_list = np.asarray(a_list, dtype=float)
        num_configs = a_list.shape[0]

    direction = np.asarray(direction_map, dtype=float)
    joint_map = np.asarray(joint_map, dtype=int)
    # pred joint j receives gt joint i's command (direction-corrected) when
    # joint_map[i] == j; unmatched pred joints stay at zero.
    pred_dof = int(joint_map.max()) + 1 if len(joint_map) else 0
    a_pred = np.zeros((num_configs, max(pred_dof, 1)))
    for gi in range(min(dof, len(joint_map))):
        if joint_map[gi] >= 0:
            a_pred[:, joint_map[gi]] = a_list[:, gi] * direction[gi]
    a_gt = a_list + np.asarray(offset)[None, :dof]

    # IDENTICAL camera rigs for both envs, matching the reference protocol
    # (its two SimEnvs place cameras deterministically the same way,
    # Sim/evaluation.py:272-310)
    env_pred = KinematicEnv.create(
        pred_urdf_path, base_orientation=pred_ori, dof=max(pred_dof, 1), radius=radius,
        num_cameras=num_cameras, global_scale=global_scale,
        asset_root=asset_root, camera_rng=np.random.default_rng(seed + 1), device=dev,
    )
    env_gt = KinematicEnv.create(
        gt_urdf_path, base_orientation=sim_ori, dof=dof, radius=radius,
        num_cameras=num_cameras, asset_root=asset_root,
        camera_rng=np.random.default_rng(seed + 1), device=dev,
    )

    losses = []
    for c in range(num_configs):
        env_pred.set_joint_positions(a_pred[c])
        env_gt.set_joint_positions(a_gt[c])
        cloud_p = env_pred.capture(num_points=num_points)
        cloud_g = env_gt.capture(num_points=num_points)

        res = icp_point_to_point(
            torch.from_numpy(cloud_p).to(dev), torch.from_numpy(cloud_g).to(dev),
            max_iterations=50, threshold=icp_threshold,
        )
        T = res.transform.cpu().numpy()
        aligned = cloud_p @ T[:3, :3].T + T[:3, 3]
        loss = float(chamfer_distance(torch.from_numpy(aligned).to(dev),
                                      torch.from_numpy(cloud_g).to(dev), norm=1))
        losses.append(loss)

        if save_path:
            for tag, cloud in (("pred", aligned), ("gt", cloud_g)):
                d = os.path.join(save_path, tag, f"{c:04}")
                os.makedirs(d, exist_ok=True)
                write_ply(os.path.join(d, "robot.ply"), cloud)

    losses = np.asarray(losses)
    if save_path:
        os.makedirs(save_path, exist_ok=True)
        np.savetxt(os.path.join(save_path, "loss.txt"), losses)
        np.savetxt(
            os.path.join(save_path, "loss_mean_std.txt"),
            (losses.mean(), losses.std()),
        )
        np.savetxt(os.path.join(save_path, "command_rad.txt"), a_list)
        np.savetxt(os.path.join(save_path, "command_deg.txt"), np.degrees(a_list))
    return losses, float(losses.mean()), float(losses.std())


def load_offset(raw_dir: str) -> np.ndarray:
    """Start angles of the first sequence (evaluation.load_offset).

    Falls back to the flat real-data layout ``raw/{robot}/V*/`` when the
    simulated step/cams level is absent (mlp_reg.py:424-426)."""
    seqs = [d for d in sorted(glob.glob(os.path.join(raw_dir, "*/")))
            if os.path.exists(os.path.join(d, "0000", "joint_cfg.txt"))]
    if not seqs:
        seqs = [d for d in sorted(glob.glob(
                    os.path.join(os.path.dirname(raw_dir), "*/")))
                if os.path.exists(os.path.join(d, "0000", "joint_cfg.txt"))]
    if not seqs:
        raise FileNotFoundError(
            f"no sequence with 0000/joint_cfg.txt under {raw_dir} or its parent")
    cfg = os.path.join(seqs[0], "0000", "joint_cfg.txt")
    vals = []
    with open(cfg) as f:
        for line in f:
            vals.append(float(line.split(":")[-1]))
    return np.asarray(vals)
