"""Motion-correlation coordinate maps.

Rebuilds CoordMap.coord_dist_map (reference/PointCloud/coord_map.py:131-332)
with the O(T*K^2) python loops collapsed into vectorized numpy: the
(K, K) per-step dissimilarity between cluster trajectories, in three
flavors matching the reference's flags:

- ``mode="pose"``  (reference diff=False, the default CLI path): per step,
  lambda_bbox * ||p_j - p_k|| + (1/pi) * geodesic(R_j, R_k), summed |.|
  over steps.
- ``mode="diff"``  (reference diff=True): per step, first the motion-delta
  distance map (translation deltas bbox-normalized; rotation deltas as
  rotvec geodesic / pi), then the second-order row-distance map, summed.
- ``mode="legacy"``: step-0-relative translation + raw quaternion
  component distances, min-max normalized.

Port of autourdf_tpu.structure.coord_map: the same numpy code; the
quaternion conversion and the carry test's nearest-neighbour search run on
tensors (core/rotations.py, ops/knn.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from ..core import rotations as R
from ..ops.knn import nn_search


def _pairwise_norm(x: np.ndarray) -> np.ndarray:
    """(..., K, D) -> (..., K, K) euclidean distance along last dim."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    return np.linalg.norm(diff, axis=-1)


def _geodesic_pairwise(rots: np.ndarray) -> np.ndarray:
    """(K, 3, 3) -> (K, K) rotation geodesic angles."""
    rel = np.einsum("kji,ljm->klim", rots, rots)  # R_k^T R_l
    tr = np.trace(rel, axis1=-2, axis2=-1)
    return np.arccos(np.clip((tr - 1.0) * 0.5, -1.0, 1.0))


def _rotvec_geodesic_pairwise(rv: np.ndarray) -> np.ndarray:
    """(K, 3) rotation vectors -> (K, K) geodesic angles between them."""
    q = ScipyRot.from_rotvec(rv).as_quat()  # (K, 4) xyzw
    dots = np.abs(q @ q.T).clip(0.0, 1.0)
    return 2.0 * np.arccos(dots)


@dataclass
class CoordMap:
    """Per-sequence registered trajectories of the K cluster frames."""

    matrices: np.ndarray          # (T, K, 4, 4)
    coords: np.ndarray            # (T, K, 7) xyz + quat(wxyz)
    cluster_points: list          # T x (N_t, 3) local-frame flat points
    cluster_labels: list          # T x (N_t,)
    bbox_diag: float              # diagonal of the union of raw clouds
    raw_clouds: list | None = None  # T x (N_t, 3) observed world clouds

    @property
    def num_coords(self) -> int:
        return self.coords.shape[1]

    @property
    def scale(self) -> float:
        """Spatial extent of the frame-0 cluster centers (viz sizing)."""
        span = self.coords[0, :, :3].max(0) - self.coords[0, :, :3].min(0)
        return float(span.max())

    @classmethod
    def from_arrays(
        cls, matrices, cluster_points, cluster_labels, raw_clouds
    ) -> "CoordMap":
        m = np.asarray(matrices, dtype=np.float64)
        quat = R.matrix_to_quat(torch.from_numpy(m[..., :3, :3].astype(np.float32))).numpy()
        coords = np.concatenate([m[..., :3, 3], quat], axis=-1)
        allpts = np.concatenate([np.asarray(c) for c in raw_clouds], axis=0)
        diag = float(np.linalg.norm(allpts.max(0) - allpts.min(0)))
        return cls(m, coords, list(cluster_points), list(cluster_labels), diag,
                   raw_clouds=[np.asarray(c) for c in raw_clouds])

    # ------------------------------------------------------------------

    def dist_map(self, mode: str = "pose") -> tuple[np.ndarray, np.ndarray]:
        """Returns (per-step (K, K, T') maps, summed (K, K) map)."""
        if mode == "pose":
            maps = self._pose_maps()
        elif mode == "diff":
            maps = self._diff_maps()
        elif mode == "legacy":
            maps = self._legacy_maps()
        elif mode == "rigid":
            maps = self._rigid_maps()
        else:
            raise ValueError(f"unknown dist map mode {mode!r}")
        stacked = np.stack(maps, axis=2)
        sum_map = np.sum(np.abs(stacked), axis=2)
        if mode == "legacy":
            sum_map = (sum_map - sum_map.min()) / max(sum_map.max() - sum_map.min(), 1e-12)
        return stacked, sum_map

    def _lambdas(self):
        return 1.0 / math.pi, 1.0 / (2.0 * self.bbox_diag)

    def _pose_maps(self) -> list[np.ndarray]:
        lam_rot, lam_bbox = self._lambdas()
        maps = []
        for i in range(self.coords.shape[0]):
            d_xyz = lam_bbox * _pairwise_norm(self.coords[i, :, :3])
            d_rot = lam_rot * _geodesic_pairwise(self.matrices[i, :, :3, :3])
            maps.append(d_xyz + d_rot)
        return maps

    def _diff_maps(self) -> list[np.ndarray]:
        lam_rot, lam_bbox = self._lambdas()
        T = self.coords.shape[0]
        trans_diff = np.diff(self.coords[:, :, :3], axis=0)  # (T-1, K, 3)
        # per-step relative rotation of each cluster, as rotvec
        rot_diff = np.zeros((T - 1, self.num_coords, 3))
        for i in range(T - 1):
            rel = np.einsum(
                "kji,kjl->kil", self.matrices[i, :, :3, :3], self.matrices[i + 1, :, :3, :3]
            )
            rot_diff[i] = ScipyRot.from_matrix(rel).as_rotvec()
        maps = []
        for i in range(T - 1):
            d_xyz = lam_bbox * _pairwise_norm(trans_diff[i])
            d_rot = lam_rot * _rotvec_geodesic_pairwise(rot_diff[i])
            # second-order: distance between dissimilarity profiles
            trans_dist = _pairwise_norm(d_xyz)
            rot_dist = _pairwise_norm(d_rot)
            maps.append(trans_dist + rot_dist)
        return maps

    def _rigid_maps(self) -> list[np.ndarray]:
        """Relative-pose *deviation* maps (ours, beyond reference).

        The reference's maps measure the mean relative pose between
        cluster trajectories, which confounds spatial separation with
        articulation (two near, co-moving clusters on different links look
        more similar than two far clusters on the same link).  Rigidity is
        a statement about time-variance instead: if clusters j, k ride the
        same rigid body then ``R_j(t)^T R_k(t)`` and ``R_j(t)^T (p_k(t) -
        p_j(t))`` are constant over time up to registration noise, while a
        joint between them makes both wander with the joint angle.  The
        per-step map is the deviation of that relative transform from its
        step-0 value — near the registration noise floor for same-link
        pairs, growing with excitation across joints.
        """
        lam_rot, lam_bbox = self._lambdas()
        Rm = self.matrices[:, :, :3, :3]     # (T, K, 3, 3)
        p = self.matrices[:, :, :3, 3]       # (T, K, 3)
        # R_rel[t, j, k] = R_j(t)^T R_k(t)
        Rrel = np.einsum("tjai,tkam->tjkim", Rm, Rm)
        dp = p[:, None, :, :] - p[:, :, None, :]       # (T, j, k, 3) p_k - p_j
        trel = np.einsum("tjai,tjka->tjki", Rm, dp)    # R_j^T (p_k - p_j)
        # deviation from the step-0 relative transform
        dR = np.einsum("jkai,tjkam->tjkim", Rrel[0], Rrel)  # Rrel0^T Rrel_t
        tr = np.trace(dR, axis1=-2, axis2=-1)
        ang = np.arccos(np.clip((tr - 1.0) * 0.5, -1.0, 1.0))   # (T, K, K)
        dt = np.linalg.norm(trel - trel[0], axis=-1)            # (T, K, K)
        dev = lam_bbox * dt + lam_rot * ang
        # the translation deviation is expressed in frame j; symmetrize
        dev = 0.5 * (dev + np.swapaxes(dev, 1, 2))
        return [dev[t] for t in range(1, dev.shape[0])]

    def _legacy_maps(self) -> list[np.ndarray]:
        maps = []
        for i in range(self.coords.shape[0]):
            xyz_rel = self.coords[i, :, :3] - self.coords[0, :, :3]
            d_xyz = _pairwise_norm(xyz_rel)
            d_q = _pairwise_norm(self.coords[i, :, 3:])
            maps.append(d_xyz + d_q)
        return maps

    # ------------------------------------------------------------------

    def summed_center_distance_matrix(self) -> np.ndarray:
        """Pairwise distances of time-summed xyz centers (MST input,
        reference coord_mst, coord_map.py:334-348)."""
        s = np.sum(self.coords[:, :, :3], axis=0)
        return _pairwise_norm(s)


def _carried_frame_dist(carried: torch.Tensor, clouds: torch.Tensor) -> torch.Tensor:
    """Mean NN distance of each carried point set to its frame's cloud:
    ``carried (F, K, K, P, 3)``, ``clouds (F, M, 3)`` -> ``(F, K, K)``.
    One launch of the nearest-neighbour kernel serves all ``F`` frames."""
    F, K, K2, P = carried.shape[:4]
    d, _ = nn_search(carried.reshape(F, -1, 3), clouds, norm=2)
    return torch.sqrt(torch.clamp_min(d, 0.0)).reshape(F, K, K2, P).mean(-1)


def swap_consistency_map(
    cm: CoordMap,
    samples_per_cluster: int = 64,
    target_points: int = 2048,
    seed: int = 0,
    raw: bool = False,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Observation-level rigidity test (ours, beyond reference).

    For each cluster pair (j, k): carry cluster j's frame-0 world points
    with cluster *k*'s registered motion, and measure their mean distance
    to the actually observed cloud at each frame.  Same rigid body -> k's
    motion is j's motion -> the carried points land on the observed
    surface (distance = sensor/registration noise).  Across a joint ->
    they land in free space.

    Unlike frame-trajectory maps this is immune to the cylinder-spin
    ambiguity: a registration twist about a link's symmetry axis maps the
    observed surface to itself, so observation-equivalent motions score
    identically (cluster frames on smooth round links spin incoherently
    and pollute pose-deviation maps — the franka/ur5 shoulder failure).

    Per-pair noise floors (the diagonal d(j,j)) are subtracted so the map
    is in "excess off-surface distance" units, then bbox-normalized.
    The search runs on ``device``: frames whose subsampled clouds have the
    same size share one NN-kernel launch over all their K^2 carried point
    sets (the subsampling itself stays on the host, drawn in frame order).
    """
    rng = np.random.default_rng(seed)
    T, K = cm.matrices.shape[:2]
    P = samples_per_cluster

    # cluster j's frame-0 world points, subsampled to P (repeat-padded)
    pts0 = np.asarray(cm.cluster_points[0])
    labels0 = np.asarray(cm.cluster_labels[0])
    m0 = np.asarray(cm.matrices[0])
    X0 = np.zeros((K, P, 3), np.float32)
    for j in range(K):
        sel = np.nonzero(labels0 == j)[0]
        if len(sel) == 0:
            continue
        pick = sel[rng.integers(0, len(sel), P)] if len(sel) < P else \
            rng.choice(sel, P, replace=False)
        X0[j] = pts0[pick] @ m0[j, :3, :3].T + m0[j, :3, 3]

    # relative motions rel[t, k] = M_t^k (M_0^k)^-1
    minv0 = np.linalg.inv(m0)
    rel = np.einsum("tkab,kbc->tkac", np.asarray(cm.matrices), minv0)

    # carried points: Y[t, k, j, p] = rel[t, k] @ X0[j, p]
    d_sum = np.zeros((K, K))
    clouds = cm.raw_clouds
    if clouds is None:
        raise ValueError("swap_consistency_map needs CoordMap.raw_clouds")

    carried_t, cloud_t = [], []
    for t in range(1, T):
        Rt = rel[t, :, :3, :3].astype(np.float32)   # (K, 3, 3)
        tt = rel[t, :, :3, 3].astype(np.float32)
        carried_t.append(np.einsum("kab,jpb->kjpa", Rt, X0) + tt[:, None, None, :])
        cloud = np.asarray(clouds[t], np.float32)
        if len(cloud) > target_points:
            cloud = cloud[rng.choice(len(cloud), target_points, replace=False)]
        cloud_t.append(cloud)
    by_size: dict[int, list[int]] = {}
    for f, cloud in enumerate(cloud_t):
        by_size.setdefault(len(cloud), []).append(f)
    for fs in by_size.values():
        dmat = _carried_frame_dist(
            torch.from_numpy(np.stack([carried_t[f] for f in fs])).to(device),
            torch.from_numpy(np.stack([cloud_t[f] for f in fs])).to(device))
        # dmat[f, k, j] = dist of j's points under k's motion
        d_sum += dmat.double().sum(0).T.cpu().numpy()
    d_mean = d_sum / max(T - 1, 1)
    if raw:
        # d_mean[j, k] = mean off-surface distance of cluster j's points
        # carried by cluster k's motion (no floor subtraction / normalizing)
        return d_mean

    floor = np.diag(d_mean)
    excess = d_mean - np.maximum(floor[:, None], floor[None, :])
    excess = np.maximum(excess, 0.0)
    excess = 0.5 * (excess + excess.T)
    np.fill_diagonal(excess, 0.0)
    return excess / max(cm.bbox_diag, 1e-12)


def swap_consistency_stack(cms: list["CoordMap"], **kwargs) -> np.ndarray:
    """(S, K, K) per-sequence raw carry matrices (see swap_consistency_map).

    Computed once and shared by the carry-test reassignment and the
    rigidity guard so the (T x K x P)-point transport runs a single time
    per pipeline invocation."""
    return np.stack([swap_consistency_map(cm, raw=True, **kwargs)
                     for cm in cms])


def _refine_groups_with_matrix(
    d: np.ndarray,
    groups: list[set[int]],
    margin: float = 0.8,
    verbose: bool = False,
) -> list[set[int]]:
    """Carry-test reassignment on a precomputed mean raw carry matrix
    (pure-array core of refine_groups_by_carry)."""
    K = d.shape[0]
    labels = np.full(K, -1)
    for gi, g in enumerate(groups):
        for j in g:
            labels[j] = gi
    out = [set(g) for g in groups]
    for j in range(K):
        cur = labels[j]
        if cur < 0:
            # cluster not covered by any group (e.g. dropped upstream) —
            # there is no "current" link to score against; leave it out
            # rather than silently indexing out[-1]
            continue
        if len(out[cur]) <= 1:
            # a singleton link has no other member to score j against —
            # and dissolving a link is a structure change, not a boundary
            # fix; leave it to the DoF search
            continue

        def group_score(gi):
            members = [k for k in out[gi] if k != j]
            return min(d[j, k] for k in members) if members else np.inf

        cur_score = group_score(cur)
        best_gi, best_score = cur, cur_score
        for gi in range(len(out)):
            if gi == cur:
                continue
            s = group_score(gi)
            if s < best_score:
                best_gi, best_score = gi, s
        if best_gi != cur and best_score < margin * cur_score:
            out[cur].discard(j)
            out[best_gi].add(j)
            labels[j] = best_gi
            if verbose:
                print(f"[structure] carry test moved cluster {j}: "
                      f"link {cur} ({cur_score:.4f}) -> link {best_gi} "
                      f"({best_score:.4f})")
    return [g for g in out if g]


def refine_groups_by_carry(
    cms: list[CoordMap],
    groups: list[set[int]],
    margin: float = 0.8,
    verbose: bool = False,
    stack: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> list[set[int]]:
    """Reassign boundary-straddling clusters by the carry test (ours).

    k-means segments cut across joints, so a cluster near a joint can be
    grouped with the wrong link even when the link COUNT is right (the
    franka elbow case: one shoulder-side cluster grouped distally, which
    poisons that link's mesh and the re-simulation at bent configs).  For
    each cluster j, score every candidate link g by the best
    observation-level explanation its member motions give j's points
    (min over k in g, k != j, of the raw carry distance), averaged over
    sequences; move j only when another link explains it ``margin`` times
    better than its own (excluding j itself, whose self-explanation is
    trivially perfect).  Empty groups are dropped.
    """
    if stack is None:
        stack = swap_consistency_stack(cms, device=device)
    return _refine_groups_with_matrix(stack.mean(axis=0), groups, margin,
                                      verbose)


def combined_sum_map(cms: list[CoordMap], mode: str = "pose",
                     device: str | torch.device = "cuda") -> np.ndarray:
    """Combine per-sequence sum maps and min-max normalize (main():667-671).

    Reference modes average across sequences.  The ``rigid`` deviation map
    combines with max instead: a pair is non-rigid if *any* sequence
    excites the joint between them, and averaging would dilute joints that
    only one sequence moves by the sequence count.  ``device`` is where
    the ``swap`` and ``hybrid`` modes run their carry test.
    """
    if mode == "hybrid":
        # pose map + observation-level swap map, each normalized then
        # averaged: pose deviation separates links whose FRAMES move
        # coherently; the carry/swap test separates links whose POINTS
        # are not mutually explained even when the pose signal sits at
        # the noise floor (the storage quiet-door case).  Averaging
        # halves either map's margin at worst but preserves any
        # separation present in at least one of them.
        pose = combined_sum_map(cms, "pose")
        swap = combined_sum_map(cms, "swap", device)
        m = 0.5 * (pose + swap)
        return (m - m.min()) / max(m.max() - m.min(), 1e-12)
    if mode == "swap":
        maps = [swap_consistency_map(cm, device=device) for cm in cms]
    else:
        maps = [cm.dist_map(mode)[1] for cm in cms]
    m = np.max(maps, axis=0) if mode in ("rigid", "swap") else np.mean(maps, axis=0)
    return (m - m.min()) / max(m.max() - m.min(), 1e-12)
