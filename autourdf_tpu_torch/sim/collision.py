"""Approximate self-collision detection from sampled link surfaces.

Stands in for PyBullet's ``getContactPoints(robot, robot)``
(reference/Sim/sim_data.py:200-208): two links collide when their
posed surface samples come within a threshold.  Directly-jointed link
pairs are excluded (PyBullet's default adjacent-link exclusion under
URDF_USE_SELF_COLLISION), plus any user-excluded pairs from the robot
config (parameters.json ``excluded_pairs``).

Copy of autourdf_tpu.sim.collision (numpy only).
"""

from __future__ import annotations

import numpy as np

from ..urdf.parser import RobotModel


class CollisionChecker:
    def __init__(
        self,
        model: RobotModel,
        link_samples: dict[str, np.ndarray],
        excluded_pairs: list[tuple[str, str]] | None = None,
        max_points_per_link: int = 400,
    ):
        self.model = model
        rng = np.random.default_rng(0)
        self.subsets: dict[str, np.ndarray] = {}
        for name, pts in link_samples.items():
            if len(pts) > max_points_per_link:
                idx = rng.choice(len(pts), max_points_per_link, replace=False)
                self.subsets[name] = pts[idx]
            else:
                self.subsets[name] = pts

        self.baseline: dict[tuple[str, str], float] = {}
        adjacent = set()
        for j in model.joints:
            adjacent.add(frozenset((j.parent, j.child)))
        for a, b in excluded_pairs or []:
            adjacent.add(frozenset((a, b)))
        # fixed-joint chains act as one rigid body: also exclude pairs
        # connected through fixed joints only
        fixed_groups = self._rigid_groups()
        names = list(self.subsets)
        self.pairs = []
        for i in range(len(names)):
            for jx in range(i + 1, len(names)):
                a, b = names[i], names[jx]
                if frozenset((a, b)) in adjacent:
                    continue
                if fixed_groups.get(a) == fixed_groups.get(b):
                    continue
                self.pairs.append((a, b))

    def _rigid_groups(self) -> dict[str, int]:
        parent = {name: name for name in self.model.links}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for j in self.model.joints:
            if j.type == "fixed":
                parent[find(j.parent)] = find(j.child)
        return {n: find(n) for n in self.model.links}

    def _pair_distances(
        self, world: dict[str, np.ndarray], reject: float
    ) -> dict[tuple[str, str], float]:
        posed = {
            name: pts @ world[name][:3, :3].T + world[name][:3, 3]
            for name, pts in self.subsets.items()
        }
        out = {}
        for a, b in self.pairs:
            pa, pb = posed[a], posed[b]
            # quick AABB reject
            if (pa.min(0) - reject > pb.max(0)).any() or (
                pb.min(0) - reject > pa.max(0)
            ).any():
                out[(a, b)] = reject
                continue
            d2 = np.sum((pa[:, None, :] - pb[None, :, :]) ** 2, axis=-1)
            out[(a, b)] = float(np.sqrt(d2.min()))
        return out

    def calibrate(self, world: dict[str, np.ndarray]) -> None:
        """Record per-pair rest distances at a known collision-free pose.

        Assemblies whose parts interlock permanently (e.g. the wx200
        gripper prop at 0.3 mm from the gripper bar) would otherwise
        false-positive forever; PyBullet never reports them because their
        collision meshes do not penetrate.
        """
        self.baseline = self._pair_distances(world, reject=1.0)

    def self_collision(
        self, world: dict[str, np.ndarray], threshold: float
    ) -> bool:
        dists = self._pair_distances(world, reject=max(threshold, 1e-6))
        for pair, d in dists.items():
            if d >= threshold:
                continue
            base = self.baseline.get(pair, np.inf)
            if d < 0.6 * base:  # genuinely closed in vs. resting proximity
                return True
        return False
