"""Joint-accuracy evaluation: predicted URDF vs ground truth.

Rebuilds compare_joints (reference/Sim/evaluation.py:84-224) on our
FK stack: load both URDFs, compute world-frame axis lines of the first
``dof`` revolute joints (gt posed at the recorded start offsets), pair
them through a joint index map, and report the line-to-line normal
distance and the axis angle folded at 90 degrees.

The reference requires a hand-authored Sim/joint_map/{robot}.txt
permutation; we support those files *and* an automatic assignment
(Hungarian matching on the combined error) when no map is given.

Copy of autourdf_tpu.eval.joints_eval (numpy and scipy only), kept here so
the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..urdf.fk import joint_world_frames
from ..urdf.parser import load_urdf

# Chain-depth tie-breaker weight for the automatic Hungarian assignment,
# as a fraction of the finite-cost spread (see compare_joints).  Must
# stay far below 1 so it can only resolve geometric ties (collinear
# joints), never override a genuine distinction.
TIE_BREAK_SCALE = 1e-3

# Tree-consistency repair weight (per violated ancestor pair), as a
# fraction of the finite-cost spread.  Above the tie-breaker (it must win
# against depth-order noise) and far below 1 (a swap that fixes even ~20
# violations cannot override a genuine geometric distinction).  See
# _repair_assignment_consistency.
VIOLATION_SCALE = 3e-3


def _joint_ancestor_matrix(model, count: int | None = None) -> np.ndarray:
    """anc[i, j] = revolute joint i lies on joint j's path to the root.

    Uses ALL joints (fixed included) for link parentage, then checks
    whether joint i's child link is an ancestor of (or equal to) joint
    j's parent link."""
    js = model.revolute_joints[:count] if count else model.revolute_joints
    parent_of = {j.child: j.parent for j in model.joints}
    paths = []
    for j in js:
        path = set()
        link = j.parent
        while link is not None:
            path.add(link)
            link = parent_of.get(link)
        paths.append(path)
    n = len(js)
    anc = np.zeros((n, n), dtype=bool)
    for i in range(n):
        for jj in range(n):
            anc[i, jj] = i != jj and js[i].child in paths[jj]
    return anc


def _repair_assignment_consistency(
    cost: np.ndarray,
    joint_map: np.ndarray,
    anc_gt: np.ndarray,
    anc_pred: np.ndarray,
    mu: float,
) -> np.ndarray:
    """Swap assignments between gt joints while it reduces
    geometric cost + mu * (ancestor-relation violations).

    The Hungarian step assigns each joint independently, so structurally
    IMPOSSIBLE matchings survive when geometry is symmetric: bolt's two
    legs have collinear HAA axes (one shared hip line) and collinear HFE
    axes, and the independent assignment crossed the legs — gt FL_HAA
    landed on one predicted leg chain while FL_HFE/KFE landed on the
    other.  Every per-joint error stayed under 3 deg, yet commanding a
    single gt joint split the posture across both predicted legs (resim
    0.109 with near-perfect joints; scripts/resim_bisect.py isolated it
    to the hip-flexion pair).  Requiring the matching to preserve
    ancestor relations between the two trees removes exactly this class
    of error, and the mu scale keeps it from ever overriding a genuine
    geometric distinction."""
    n = len(joint_map)
    jm = joint_map.copy()

    def total(jm_):
        t = 0.0
        for g in range(n):
            if 0 <= jm_[g] < cost.shape[1]:
                t += cost[g, jm_[g]]
        v = 0
        for a in range(n):
            ma = jm_[a]
            if ma < 0:
                continue
            for b in range(n):
                mb = jm_[b]
                if b == a or mb < 0:
                    continue
                if anc_gt[a, b] != anc_pred[ma, mb]:
                    v += 1
        return t + mu * v

    best = total(jm)
    for _ in range(n * n):
        improved = False
        for a in range(n):
            for b in range(a + 1, n):
                cand = jm.copy()
                cand[a], cand[b] = cand[b], cand[a]
                val = total(cand)
                if val < best - 1e-15:
                    jm, best, improved = cand, val, True
        if not improved:
            # single swaps between mirror-symmetric chains are exactly
            # cost-neutral AND violation-neutral (bolt: swapping only the
            # HFE pair leaves the KFE pair crossed), so the crossed-chain
            # minimum sits behind a plateau reachable only by a
            # coordinated pair of transpositions — search those before
            # giving up
            pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
            for i, (a, b) in enumerate(pairs):
                for c, d in pairs[i + 1:]:
                    if len({a, b, c, d}) < 4:
                        continue
                    cand = jm.copy()
                    cand[a], cand[b] = cand[b], cand[a]
                    cand[c], cand[d] = cand[d], cand[c]
                    val = total(cand)
                    if val < best - 1e-15:
                        jm, best, improved = cand, val, True
                        break
                if improved:
                    break
        if not improved:
            break
    return jm


def joint_error(pos_a, uv_a, pos_b, uv_b) -> tuple[float, float]:
    """(normal distance between axis lines, angle between axes in deg)."""
    na, nb = np.linalg.norm(uv_a), np.linalg.norm(uv_b)
    if na < 1e-12 or nb < 1e-12 or not (np.all(np.isfinite(uv_a)) and np.all(np.isfinite(uv_b))):
        return float("inf"), 90.0  # degenerate axis: worst-case but finite angle
    uv_a = np.asarray(uv_a) / na
    uv_b = np.asarray(uv_b) / nb
    cross = np.cross(uv_a, uv_b)
    cmag = np.linalg.norm(cross)
    diff = np.asarray(pos_b) - np.asarray(pos_a)
    if cmag == 0:
        pos_error = np.linalg.norm(np.cross(diff, uv_a))
    else:
        pos_error = abs(diff @ cross) / cmag
    dot = float(np.clip(np.dot(uv_a, uv_b), -1.0, 1.0))
    return float(pos_error), float(np.degrees(np.arccos(dot)))


@dataclass
class JointComparison:
    pos_errors: list[float]
    dir_errors: list[float]
    direction_map: list[int]   # +1 / -1 per joint (axis flipped vs gt)
    joint_map: np.ndarray      # pred joint index used for each gt joint
    # coverage accounting: under-discovery must not silently flatter the
    # matched-subset means, so unmatched gt joints carry a defined penalty
    # (90 deg direction, robot-scale position) in the *complete* aggregates.
    matched: int = 0
    total: int = 0
    pos_errors_complete: list[float] | None = None
    dir_errors_complete: list[float] | None = None

    @property
    def dir_mean_matched(self) -> float:
        return float(np.mean(self.dir_errors)) if self.dir_errors else 90.0

    @property
    def pos_mean_matched(self) -> float:
        return float(np.mean(self.pos_errors)) if self.pos_errors else float("nan")

    @property
    def dir_mean_complete(self) -> float:
        return float(np.mean(self.dir_errors_complete)) if self.dir_errors_complete else 90.0

    @property
    def pos_mean_complete(self) -> float:
        return (float(np.mean(self.pos_errors_complete))
                if self.pos_errors_complete else float("nan"))


def _world_axes(urdf_path, base_orientation, q, dof, global_scale, asset_root):
    from scipy.spatial.transform import Rotation as ScipyRot

    model = load_urdf(urdf_path, asset_root=asset_root, load_meshes=False,
                      global_scale=global_scale)
    base = np.eye(4)
    base[:3, :3] = ScipyRot.from_euler("xyz", base_orientation).as_matrix()
    frames = joint_world_frames(model, q, base)
    return frames[:dof] if dof else frames


def compare_joints(
    pred_urdf_path: str,
    gt_urdf_path: str,
    dof: int,
    offset: np.ndarray | None = None,
    sim_ori=(0, 0, 0),
    pred_ori=(0, 0, 0),
    joint_map: np.ndarray | None = None,
    global_scale: float = 1.0,
    asset_root: str | None = None,
) -> JointComparison:
    pred_all = _world_axes(pred_urdf_path, pred_ori, None, None, global_scale, asset_root)

    gt_model = load_urdf(gt_urdf_path, asset_root=asset_root, load_meshes=False)
    q = {}
    if offset is not None:
        for j, o in zip(gt_model.revolute_joints[:dof], offset):
            q[j.name] = float(o)
    from scipy.spatial.transform import Rotation as ScipyRot

    gt_base = np.eye(4)
    gt_base[:3, :3] = ScipyRot.from_euler("xyz", sim_ori).as_matrix()
    gt_frames = joint_world_frames(gt_model, q, gt_base, dof=dof)

    n = min(dof, len(gt_frames))
    if joint_map is None:
        # automatic assignment: Hungarian on pos + scaled dir error.
        # When the predicted URDF has fewer joints than the gt dof
        # (under-discovered DoF), unmatched gt joints get map entry -1 and
        # are skipped in the error lists.
        from scipy.optimize import linear_sum_assignment

        np_pred = len(pred_all)
        cost = np.full((n, max(np_pred, 1)), 1e6)
        for gi in range(n):
            for pi in range(np_pred):
                pe, de = joint_error(
                    pred_all[pi].position, pred_all[pi].axis,
                    gt_frames[gi].position, gt_frames[gi].axis,
                )
                de = min(de, 180.0 - de)
                cost[gi, pi] = pe + de / 90.0
        cost = np.where(np.isfinite(cost), cost, 1e6)  # degenerate axes
        # COLLINEAR joints (franka's pan and roll share one axis line at
        # the home config) have identical line-to-line cost either way, so
        # the assignment would be arbitrary — and a swap sends re-sim
        # commands to the wrong joints.  A tiny chain-depth tie-breaker
        # (both joint lists are in kinematic order) resolves exactly those
        # ties without ever overriding a genuine geometric distinction.
        if n > 1 and np_pred > 1:
            gi_d = np.arange(n)[:, None] / (n - 1)
            pi_d = np.arange(np_pred)[None, :] / (np_pred - 1)
            # the epsilon scales with the spread of the real (finite,
            # sub-sentinel) costs so the tie-breaker stays three orders of
            # magnitude below genuine geometric distinctions even when the
            # whole cost matrix is tightly grouped (sub-mm differences)
            real = cost[cost < 1e5]
            spread = float(real.max() - real.min()) if real.size else 1.0
            cost = cost + TIE_BREAK_SCALE * max(spread, 1e-9) * np.abs(gi_d - pi_d)
        rows, cols = linear_sum_assignment(cost)
        joint_map = np.full(n, -1, dtype=int)
        joint_map[rows] = cols
        # structural repair: geometric symmetry (collinear left/right leg
        # axes) can cross kinematic chains; enforce ancestor consistency
        pred_model = load_urdf(pred_urdf_path, asset_root=asset_root,
                               load_meshes=False)
        anc_gt = _joint_ancestor_matrix(gt_model, n)
        anc_pred = _joint_ancestor_matrix(pred_model)
        real = cost[cost < 1e5]
        spread = float(real.max() - real.min()) if real.size else 1.0
        joint_map = _repair_assignment_consistency(
            cost, joint_map, anc_gt, anc_pred,
            mu=VIOLATION_SCALE * max(spread, 1e-9),
        )
    else:
        joint_map = np.asarray(joint_map, dtype=int)

    # penalty scale for unmatched gt joints: the span of the gt joint
    # positions (a robot-scale length), floored to avoid a zero penalty on
    # single-joint robots.
    gt_pos = np.array([g.position for g in gt_frames[:n]]) if n else np.zeros((0, 3))
    pos_penalty = 0.1
    if len(gt_pos) >= 2:
        span = float(np.linalg.norm(gt_pos.max(0) - gt_pos.min(0)))
        pos_penalty = max(span, 0.1)

    pos_errors, dir_errors, dir_map = [], [], []
    pos_complete, dir_complete = [], []
    for gi in range(n):
        if joint_map[gi] < 0 or joint_map[gi] >= len(pred_all):
            dir_map.append(1)
            pos_complete.append(pos_penalty)
            dir_complete.append(90.0)
            continue
        p = pred_all[joint_map[gi]]
        g = gt_frames[gi]
        pe, de = joint_error(p.position, p.axis, g.position, g.axis)
        if de > 90.0:
            de = 180.0 - de
            dir_map.append(-1)
        else:
            dir_map.append(1)
        pos_errors.append(pe)
        dir_errors.append(de)
        pos_complete.append(pe)
        dir_complete.append(de)
    return JointComparison(
        pos_errors, dir_errors, dir_map, joint_map,
        matched=len(pos_errors), total=n,
        pos_errors_complete=pos_complete, dir_errors_complete=dir_complete,
    )
