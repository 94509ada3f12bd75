"""Joint axis/origin estimation from link trajectories.

Rebuilds reference/PointCloud/compute_joints.py:10-268 on our own
SE(3) stack: for each parent-child pair in the kinematic tree, cancel the
parent's motion, extract the per-interval screw axis of the child's
residual rotation, sign-align and SVD the axes into a principal axis, and
refine the joint origin along that axis by minimizing distance to both
link centers.  The scipy/transforms3d dependencies of the reference are
replaced by closed-form screw decomposition (core.se3) and an exact
golden-section line search.

Port of autourdf_tpu.joints.screw: the same numpy code, with the screw
decomposition on a tensor (core/se3.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from typing import TYPE_CHECKING

from ..core import se3
from ..core.quat_np import average_quaternions_np, pose_to_matrix_np

if TYPE_CHECKING:  # type-only; avoids a circular import with structure/
    from ..structure.coord_map import CoordMap
    from ..structure.tree import LinkNode


def cluster_pose_mean(cm: "CoordMap", members: list[int], step: int) -> tuple[np.ndarray, np.ndarray]:
    coords = cm.coords[step, members, :]
    return coords[:, :3].mean(0), average_quaternions_np(coords[:, 3:])


def _pose_to_matrix(pos: np.ndarray, quat: np.ndarray) -> np.ndarray:
    return pose_to_matrix_np(pos, quat)


def _relative(Ta: np.ndarray, Tb: np.ndarray) -> np.ndarray:
    return np.linalg.inv(Ta) @ Tb


def screw_axes_from_pose_series(
    poses_parent: list[tuple[np.ndarray, np.ndarray]],
    poses_child: list[tuple[np.ndarray, np.ndarray]],
) -> tuple[list[np.ndarray], list[float], list[np.ndarray]]:
    """Per consecutive pose pair: child's residual screw in the
    parent-motion-cancelled chain (calculate_joint_axis_relative,
    compute_joints.py:54-122)."""
    axes, angles, points = [], [], []
    Tp = [_pose_to_matrix(*p) for p in poses_parent]
    Tc = [_pose_to_matrix(*p) for p in poses_child]
    for i in range(1, len(Tp)):
        T_r = _relative(Tp[i - 1], Tp[i])
        T_child_prev = _relative(Tp[i - 1], Tc[i - 1])
        T_child_cur = _relative(Tp[i - 1], Tc[i])
        T_r2 = np.linalg.inv(T_r) @ T_child_cur
        T_r1 = np.linalg.inv(T_child_prev) @ T_r2

        axis, angle, point = se3.screw_from_transform(
            torch.from_numpy(T_r1.astype(np.float32)))
        axis = axis.numpy().astype(np.float64)
        point = point.numpy().astype(np.float64)
        # slide the point so its largest-|axis| coordinate zeroes — the
        # reference's init_position normalization (compute_joints.py:68-77)
        mi = int(np.argmax(np.abs(axis)))
        n = point[mi] / axis[mi] if abs(axis[mi]) > 1e-12 else 0.0
        axes.append(axis)
        angles.append(float(angle))
        points.append(point - n * axis)
    return axes, angles, points


def filter_screws(
    axes: list[np.ndarray],
    angles: list[float],
    points: list[np.ndarray],
    min_angle: float = 1e-4,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Drop degenerate screw samples (near-identity relative motion yields a
    zero axis and an unconstrained point, which would NaN the SVD/means).
    Falls back to the largest-angle sample if everything is degenerate."""
    keep = [
        i for i, (a, ang, p) in enumerate(zip(axes, angles, points))
        if np.linalg.norm(a) > 0.5 and ang > min_angle and np.all(np.isfinite(p))
    ]
    if not keep:
        if not angles:
            raise ValueError(
                "no screw samples: the pose series needs at least two steps "
                "(end_steps - start_steps must be >= 2)"
            )
        keep = [int(np.argmax(angles))]
    return [axes[i] for i in keep], [points[i] for i in keep]


def _principal_axis(axes: list[np.ndarray]) -> np.ndarray:
    ref = axes[0] / np.linalg.norm(axes[0])
    aligned = []
    for a in axes:
        a = a / max(np.linalg.norm(a), 1e-12)
        aligned.append(-a if a @ ref < 0 else a)
    A = np.stack(aligned)  # (M, 3)
    U, _, _ = np.linalg.svd(A.T)
    pa = U[:, 0]
    if pa @ aligned[0] < 0:
        pa = -pa
    return pa


def _golden_min(f, lo=-10.0, hi=10.0, tol=1e-10, iters=200):
    """Golden-section minimize of a unimodal 1-D function (replaces
    scipy.optimize.minimize_scalar at compute_joints.py:152)."""
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - gr * (b - a)
    d = a + gr * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        if abs(b - a) < tol:
            break
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = f(d)
    x = (a + b) / 2
    return x, f(x)


def optimize_joint_axis(
    poses_parent, poses_child, axes, points
) -> tuple[np.ndarray, list[np.ndarray], np.ndarray, np.ndarray]:
    """Aggregate per-interval screws into one joint (axis, origin).

    Mirrors optimize_joint_axis (compute_joints.py:124-214): SVD principal
    axis; mean screw point mapped through the step-0 child transform; then
    origin refined along the axis minimizing summed distance to the two
    link centers at step 0.
    """
    principal_axis = _principal_axis(axes)
    principal_pos = np.mean(points, axis=0)

    child_rots = [
        _pose_to_matrix(*p)[:3, :3] for p in poses_child
    ]
    global_axes = [rot @ principal_axis for rot in child_rots]

    T_childs = [_pose_to_matrix(*p) for p in poses_child]
    hp = np.concatenate([principal_pos, [1.0]])
    global_pos0 = (T_childs[0] @ hp)[:3]

    parent_pos0 = poses_parent[0][0]
    child_pos0 = poses_child[0][0]

    def dist_sum(t):
        p = global_pos0 + t * principal_axis
        return np.linalg.norm(parent_pos0 - p) + np.linalg.norm(child_pos0 - p)

    t_star, _ = _golden_min(dist_sum)
    global_pos = global_pos0 + t_star * principal_axis
    local_pos = np.linalg.inv(T_childs[0]) @ np.concatenate([global_pos, [1.0]])
    return principal_axis, global_axes, global_pos, local_pos


@dataclass
class JointCoherence:
    """Per-joint articulation-coherence statistics (ours, beyond reference).

    A REAL revolute joint's per-interval screw axes (the raw samples that
    :func:`estimate_joints_from_tree` pools before its SVD) all measure
    the same physical axis, so they cluster tightly around the principal
    axis — and the per-sequence principal axes agree, because each of the
    independent random-walk trajectories excites the same hinge.  A
    SPURIOUS joint born from registration drift on a large rigid shell
    has no physical axis: its per-interval screws are noise rotations
    whose axes scatter, and each sequence's drift fits a different
    "axis".  The statistics below quantify both, providing a veto signal
    the carry/magnitude tests cannot (RESULTS.md round-3: drift magnitude
    overlaps the weak-true-joint band; drift *direction* does not).
    """

    parent_link: int
    child_link: int
    n_samples: int
    #: angle-weighted resultant length of the sample axes folded onto the
    #: principal-axis hemisphere; 1.0 = perfectly coherent, ~0.5 = the
    #: expectation for isotropic noise folded to a hemisphere
    concentration: float
    #: median folded angle (deg) between sample axes and the principal axis
    median_dev_deg: float
    #: max pairwise folded angle (deg) between per-sequence principal axes
    #: (nan when fewer than 2 sequences yield enough valid samples)
    seq_spread_deg: float
    #: summed |screw angle| across samples (deg) — excitation magnitude
    total_angle_deg: float


def _folded_angle_deg(a: np.ndarray, b: np.ndarray) -> float:
    c = abs(float(np.dot(a, b)) / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12))
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _pair_screw_samples(
    cm: "CoordMap",
    parent_members: list[int],
    child_members: list[int],
    start_step: int,
    num_steps: int,
    interval: int,
    min_angle: float,
) -> tuple[list[np.ndarray], list[float]]:
    """Valid (axis, angle) screw samples for one parent-child pair in one
    sequence, pooled over the stride offsets (same sampling scheme as
    estimate_joints_from_tree)."""
    axes_out: list[np.ndarray] = []
    angles_out: list[float] = []
    for a in range(interval):
        pp, pc = [], []
        for step in range(start_step + a, start_step + num_steps, interval):
            pp.append(cluster_pose_mean(cm, parent_members, step))
            pc.append(cluster_pose_mean(cm, child_members, step))
        axes, angles, pts = screw_axes_from_pose_series(pp, pc)
        for ax, ang, pt in zip(axes, angles, pts):
            if np.linalg.norm(ax) > 0.5 and ang > min_angle and np.all(np.isfinite(pt)):
                axes_out.append(ax / np.linalg.norm(ax))
                angles_out.append(float(ang))
    return axes_out, angles_out


def joint_screw_coherence(
    links: list["LinkNode"],
    cm_list: list["CoordMap"],
    start_step: int = 0,
    num_steps: int = 10,
    interval: int = 4,
    min_angle: float = 1e-4,
) -> list[JointCoherence]:
    """Coherence statistics for every parent-child joint of ``links``.

    Uses the identical pose-series / stride sampling as
    :func:`estimate_joints_from_tree` so the statistics describe exactly
    the samples that joint estimation would consume.
    """
    interval = max(1, min(interval, num_steps // 2))
    out: list[JointCoherence] = []
    for link in links:
        if link.parent_id is None:
            continue
        parent = next(l for l in links if l.id == link.parent_id)
        pm, cm_members = sorted(parent.cluster_idx), sorted(link.cluster_idx)
        per_seq_axes: list[list[np.ndarray]] = []
        per_seq_angles: list[list[float]] = []
        for cm in cm_list:
            axes, angles = _pair_screw_samples(
                cm, pm, cm_members, start_step, num_steps, interval, min_angle)
            per_seq_axes.append(axes)
            per_seq_angles.append(angles)
        all_axes = [a for seq in per_seq_axes for a in seq]
        all_angles = [a for seq in per_seq_angles for a in seq]
        if not all_axes:
            out.append(JointCoherence(parent.id, link.id, 0, 0.0, 90.0,
                                      float("nan"), 0.0))
            continue
        principal = _principal_axis(all_axes)
        # fold every sample onto the principal hemisphere, weight by angle
        w = np.asarray(all_angles)
        A = np.stack([a if a @ principal >= 0 else -a for a in all_axes])
        resultant = (w[:, None] * A).sum(0)
        concentration = float(np.linalg.norm(resultant) / max(w.sum(), 1e-12))
        devs = [_folded_angle_deg(a, principal) for a in all_axes]
        # per-sequence principal axes (sequences with >= 2 valid samples)
        seq_axes = [
            _principal_axis(axes) for axes in per_seq_axes if len(axes) >= 2
        ]
        if len(seq_axes) >= 2:
            spread = max(
                _folded_angle_deg(seq_axes[i], seq_axes[j])
                for i in range(len(seq_axes))
                for j in range(i + 1, len(seq_axes))
            )
        else:
            spread = float("nan")
        out.append(JointCoherence(
            parent_link=parent.id,
            child_link=link.id,
            n_samples=len(all_axes),
            concentration=concentration,
            median_dev_deg=float(np.median(devs)),
            seq_spread_deg=spread,
            total_angle_deg=float(np.degrees(np.sum(all_angles))),
        ))
    return out


@dataclass
class JointEstimate:
    parent_link: int
    child_link: int
    local_axis: np.ndarray
    local_pos: np.ndarray
    global_pos: np.ndarray
    global_axis: np.ndarray


def estimate_joints_from_tree(
    links: list["LinkNode"],
    cm_list: list["CoordMap"],
    start_step: int = 0,
    num_steps: int = 10,
    interval: int = 4,
) -> list[JointEstimate]:
    """All parent-child joints (estimate_joint_axes_from_tree,
    compute_joints.py:216-268): pools pose series across sequences and
    across ``interval`` stride offsets for robustness."""
    # an interval larger than half the window would leave strides with a
    # single sample and no consecutive pose pairs
    interval = max(1, min(interval, num_steps // 2))
    out = []
    for link in links:
        if link.parent_id is None:
            continue
        parent = next(l for l in links if l.id == link.parent_id)
        all_pp, all_pc, all_axes, all_pts = [], [], [], []
        for cm in cm_list:
            for a in range(interval):
                pp, pc = [], []
                for step in range(start_step + a, start_step + num_steps, interval):
                    pp.append(cluster_pose_mean(cm, sorted(parent.cluster_idx), step))
                    pc.append(cluster_pose_mean(cm, sorted(link.cluster_idx), step))
                axes, angles, pts = screw_axes_from_pose_series(pp, pc)
                axes, pts = filter_screws(axes, angles, pts)
                all_pp.extend(pp)
                all_pc.extend(pc)
                all_axes.extend(axes)
                all_pts.extend(pts)
        local_axis, global_axes, global_pos, local_pos = optimize_joint_axis(
            all_pp, all_pc, all_axes, all_pts
        )
        out.append(
            JointEstimate(
                parent_link=parent.id,
                child_link=link.id,
                local_axis=local_axis,
                local_pos=local_pos,
                global_pos=global_pos,
                global_axis=global_axes[0],
            )
        )
    return out
