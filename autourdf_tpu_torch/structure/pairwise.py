"""Alternative pairwise kinematics path (deviation-scored greedy tree); port
of autourdf_tpu.structure.pairwise, the same host numpy code.

Rebuilds the reference's older kinematics-tree flow (kept alongside the
main pipeline; no stage of workflow.py uses it): estimate a joint between *every* pair
of link groups, score each candidate by a deviation metric (variance of
the joint-to-child distance plus variance of the per-step screw axes),
then grow a tree greedily from the least-moving base — the base may take
multiple children under a deviation threshold, every other node adopts
only its best unvisited neighbor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from ..core import se3
from ..joints.screw import (
    _golden_min,
    _principal_axis,
    cluster_pose_mean,
    screw_axes_from_pose_series,
)
from .coord_map import CoordMap


@dataclass
class PairwiseJoint:
    clusters: tuple[int, int]
    local_axis: np.ndarray
    local_pos: np.ndarray
    global_pos: np.ndarray
    global_axis: np.ndarray
    deviation: float


def _deviation(poses_parent, poses_child, screw_points, axes) -> float:
    """Variance of joint->child distances + variance of axes
    (error_function, kinematics_tree.py:171-200)."""
    distances = []
    for (pos_p, quat_p), (pos_c, _), sp in zip(
        poses_parent, poses_child, screw_points
    ):
        rot_p = ScipyRot.from_quat(
            np.concatenate([quat_p[1:], quat_p[:1]])
        ).as_matrix()
        child_in_parent = np.linalg.inv(rot_p) @ (np.asarray(pos_c) - pos_p)
        distances.append(np.linalg.norm(child_in_parent - sp))
    d = np.asarray(distances)
    dev = float(np.sum((d - d.mean()) ** 2) / len(d))
    A = np.stack(axes)
    dev += float(np.sum((A - A.mean(0)) ** 2) / len(A))
    return dev


def estimate_pairwise_joints(
    cm_list: list[CoordMap],
    groups: list[set[int]],
    start_step: int = 0,
    num_steps: int = 10,
    interval: int = 1,
) -> list[PairwiseJoint]:
    interval = max(1, min(interval, num_steps // 2))
    n = len(groups)
    out = []
    for i in range(n):
        for j in range(i + 1, n):
            all_pi, all_pj, all_axes, all_pts = [], [], [], []
            for cm in cm_list:
                for a in range(interval):
                    pi, pj = [], []
                    for step in range(start_step + a, start_step + num_steps, interval):
                        pi.append(cluster_pose_mean(cm, sorted(groups[i]), step))
                        pj.append(cluster_pose_mean(cm, sorted(groups[j]), step))
                    axes, _, pts = screw_axes_from_pose_series(pi, pj)
                    all_pi.extend(pi)
                    all_pj.extend(pj)
                    all_axes.extend(axes)
                    all_pts.extend(pts)
            axis = _principal_axis(all_axes)
            mean_pt = np.mean(all_pts, axis=0)
            Tc0 = se3.xyzquat_to_matrix(
                torch.as_tensor(np.concatenate(all_pj[0]), dtype=torch.float32)
            ).numpy().astype(np.float64)
            gp0 = (Tc0 @ np.concatenate([mean_pt, [1.0]]))[:3]

            def dist_sum(t):
                p = gp0 + t * axis
                return np.linalg.norm(all_pi[0][0] - p) + np.linalg.norm(
                    all_pj[0][0] - p
                )

            t_star, _ = _golden_min(dist_sum)
            global_pos = gp0 + t_star * axis
            local_pos = np.linalg.inv(Tc0) @ np.concatenate([global_pos, [1.0]])
            dev = _deviation(all_pi, all_pj, all_pts, all_axes)
            child_rot = Tc0[:3, :3]
            out.append(
                PairwiseJoint(
                    clusters=(i, j),
                    local_axis=axis,
                    local_pos=local_pos[:3],
                    global_pos=global_pos,
                    global_axis=child_rot @ axis,
                    deviation=dev,
                )
            )
    return out


def identify_base_group(
    cm_list: list[CoordMap], groups: list[set[int]], start_step: int, num_steps: int
) -> int:
    """Group with least mean-position motion (identify_base_cluster)."""
    motions = []
    for g in groups:
        total = 0.0
        for cm in cm_list:
            prev = None
            for step in range(start_step, start_step + num_steps):
                pos, _ = cluster_pose_mean(cm, sorted(g), step)
                if prev is not None:
                    total += float(np.linalg.norm(pos - prev))
                prev = pos
        motions.append(total)
    return int(np.argmin(motions))


def greedy_tree(
    joints: list[PairwiseJoint],
    base: int,
    deviation_threshold: float = 0.04,
) -> dict[int, list[dict]]:
    """Greedy BFS tree (construct_kinematic_tree_multi): the base adopts
    every neighbor under the threshold; other nodes adopt only their
    lowest-deviation unvisited neighbor."""
    graph: dict[int, list] = {}
    for j in joints:
        a, b = j.clusters
        graph.setdefault(a, []).append((b, j))
        graph.setdefault(b, []).append((a, j))

    tree: dict[int, list[dict]] = {base: []}
    visited = {base}
    layer = [base]
    while layer:
        nxt = []
        for node in layer:
            cands = [
                {"child": nb, "deviation": j.deviation, "axis": j.local_axis,
                 "pos": j.local_pos, "joint": j}
                for nb, j in graph.get(node, [])
                if nb not in visited
            ]
            cands.sort(key=lambda c: c["deviation"])
            if node == base:
                chosen = [c for c in cands if c["deviation"] < deviation_threshold]
            else:
                chosen = cands[:1]
            for c in chosen:
                tree[node].append(c)
                visited.add(c["child"])
                tree[c["child"]] = []
                nxt.append(c["child"])
        layer = nxt
    return tree
