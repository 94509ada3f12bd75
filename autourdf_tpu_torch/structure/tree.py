"""Kinematic tree construction from motion-grouped clusters.

Rebuilds coord_mst + kinematics_tree
(reference/PointCloud/coord_map.py:334-441): a minimum spanning
tree over time-summed cluster centers gives cluster adjacency; link-level
edges come from MST edges crossing link groups; the root is the link
whose mean 7-D coordinate moves least over time; BFS assigns parents and
breadth-first tree ids.

The JAX package builds its graphs with networkx; the port keeps a small
undirected :class:`Graph` and Kruskal's algorithm here (same edge order,
same tie rule), so the trees are identical and networkx is not needed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .coord_map import CoordMap


@dataclass
class LinkNode:
    id: int
    cluster_idx: set[int]
    connected_links: set[int] = field(default_factory=set)
    parent_id: int | None = None
    tree_id: int | None = None
    movement: float = 0.0


class Graph:
    """Undirected graph on nodes ``0..n-1`` with the few accessors the tree
    code uses (``nodes``, ``edges``, ``neighbors``)."""

    def __init__(self, n: int, edges=()):
        self.nodes = list(range(n))
        self._adj: dict[int, list[int]] = {i: [] for i in self.nodes}
        self.edges: list[tuple[int, int]] = []
        for u, v in edges:
            self.add_edge(int(u), int(v))

    def add_edge(self, u: int, v: int) -> None:
        if v not in self._adj[u]:
            self._adj[u].append(v)
            self._adj[v].append(u)
            self.edges.append((u, v))

    def neighbors(self, u: int) -> list[int]:
        return list(self._adj[u])


def minimum_spanning_edges(n: int, edges: list[tuple[int, int, float]]) -> list[tuple[int, int]]:
    """Kruskal over ``(u, v, weight)`` edges: stable sort by weight (ties
    keep the given order, as networkx's Kruskal does), union-find merge."""
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    out = []
    for u, v, _ in sorted(edges, key=lambda e: e[2]):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
            out.append((u, v))
    return out


def cluster_mst(cm: CoordMap) -> Graph:
    d = cm.summed_center_distance_matrix()
    n = cm.num_coords
    # a graph built from a weight matrix has an edge only where the entry
    # is non-zero (coincident centres are not adjacent); edges in row-major
    # order of the upper triangle, the order networkx iterates them in
    edges = [(i, j, float(d[i, j])) for i in range(n) for j in range(i + 1, n)
             if d[i, j] != 0 or d[j, i] != 0]
    return Graph(n, minimum_spanning_edges(n, edges))


def build_link_graph(groups: list[set[int]], g0: Graph) -> list[LinkNode]:
    links = [LinkNode(id=i, cluster_idx=set(g)) for i, g in enumerate(groups)]
    for link in links:
        for cid in link.cluster_idx:
            for neighbor in g0.neighbors(cid):
                for other in links:
                    if other.id != link.id and neighbor in other.cluster_idx:
                        link.connected_links.add(other.id)
    return links


def _assign_tree_ids(links: list[LinkNode], cm: CoordMap) -> list[LinkNode]:
    """Root pick (min total movement of the mean 7-D coordinate, as the
    reference) + BFS parent/tree-id assignment over LinkNode adjacency.
    Shared by the proximity and motion trees so the arbitration between
    them compares topologies, never bookkeeping."""
    for link in links:
        centers = np.mean(cm.coords[:, sorted(link.cluster_idx), :], axis=1)
        link.movement = float(
            np.sum(np.linalg.norm(np.diff(centers, axis=0), axis=1)))
    root = min(links, key=lambda l: l.movement)
    root.parent_id = None
    root.tree_id = 0
    tree_id = 1
    layer = [root]
    visited = {root.id}
    by_id = {l.id: l for l in links}
    while layer:
        nxt = []
        for cur in layer:
            children = cur.connected_links - (
                {cur.parent_id} if cur.parent_id is not None else set())
            for cid in sorted(children):
                if cid in visited:
                    continue
                child = by_id[cid]
                child.parent_id = cur.id
                child.tree_id = tree_id
                tree_id += 1
                visited.add(cid)
                nxt.append(child)
        layer = nxt
    return sorted(links, key=lambda l: (l.tree_id if l.tree_id is not None
                                        else 1 << 30))


def kinematics_tree(cm: CoordMap, groups: list[set[int]], g0: Graph) -> list[LinkNode]:
    links = build_link_graph(groups, g0)

    # root + BFS ids (note: the reference's movement norm includes the
    # quaternion components)
    return _assign_tree_ids(links, cm)


# ---------------------------------------------------------------------------
# Motion-consistency tree (beyond reference)
# ---------------------------------------------------------------------------

def _link_pose_series(cm_list, groups, num_steps):
    """Precomputed mean link poses: [seq][group][step] -> (pos, quat)."""
    from ..joints.screw import cluster_pose_mean

    return [
        [[cluster_pose_mean(cm, sorted(g), t) for t in range(num_steps)]
         for g in groups]
        for cm in cm_list
    ]


def revolute_consistency_matrix(
    cm_list, groups: list[set[int]], num_steps: int, interval: int = 4
) -> np.ndarray:
    """(L, L) single-revolute misfit between every link pair, in radians.

    For a pair connected by one revolute joint, every relative screw
    sample (parent-motion-cancelled, across steps/strides/sequences)
    shares one axis; for pairs separated by two or more joints the
    sampled axes wander.  Score = rotation-angle-weighted mean angle
    between each sample axis and the sign-aligned principal axis — the
    same statistic that separates the ur5 wrist mis-ordering (38 deg for
    the forearm->wrist2 composite vs <=11 deg for every true joint).

    The parent-motion-cancelled screw of the pair over one stride
    simplifies exactly to ``rel(t0)^-1 rel(t1)`` with
    ``rel(t) = M_i(t)^-1 M_j(t)`` (see joints/screw.py
    screw_axes_from_pose_series for the long form), so the whole matrix
    vectorizes: one batched rotvec over all pairs x samples instead of
    O(L^2 * samples) per-matrix jax dispatches (19-link pxs: seconds,
    not ~45 minutes).
    """
    from scipy.spatial.transform import Rotation as ScipyRot

    from ..core.quat_np import pose_to_matrix_np

    interval = max(1, min(interval, num_steps // 2))
    L = len(groups)
    S = len(cm_list)
    series = _link_pose_series(cm_list, groups, num_steps)
    M = np.zeros((S, L, num_steps, 4, 4))
    for s in range(S):
        for g in range(L):
            for t in range(num_steps):
                M[s, g, t] = pose_to_matrix_np(*series[s][g][t])

    # rel[s, i, j, t] = M_i(t)^-1 M_j(t)
    Minv = np.linalg.inv(M)
    rel = np.einsum("sitab,sjtbc->sijtac", Minv, M)
    t0 = np.arange(num_steps - interval)
    # delta[s, i, j, k] = rel(t0_k)^-1 rel(t0_k + interval)
    delta = np.einsum("sijkba,sijkbc->sijkac",
                      rel[:, :, :, t0], rel[:, :, :, t0 + interval])
    P = len(t0)
    rots = delta[..., :3, :3].reshape(-1, 3, 3)
    w = ScipyRot.from_matrix(rots).as_rotvec().reshape(S, L, L, P, 3)
    ang = np.linalg.norm(w, axis=-1)                      # (S, L, L, P)
    axes = w / np.maximum(ang[..., None], 1e-12)

    # collapse (S, P) sample dims; weight by angle, filter degenerates
    axes = np.moveaxis(axes, 0, 2).reshape(L, L, S * P, 3)
    ang = np.moveaxis(ang, 0, 2).reshape(L, L, S * P)
    valid = ang > 1e-4

    D = np.zeros((L, L))
    no_sample = []
    for i in range(L):
        for j in range(i + 1, L):
            v = valid[i, j]
            if not v.any():
                no_sample.append((i, j))
                continue
            A = axes[i, j][v]
            wgt = ang[i, j][v]
            ref = A[0]
            A = np.where((A @ ref)[:, None] < 0, -A, A)
            U, _, _ = np.linalg.svd(A.T, full_matrices=False)
            pa = U[:, 0]
            dev = np.arccos(np.clip(np.abs(A @ pa), 0.0, 1.0))
            D[i, j] = D[j, i] = float(np.sum(dev * wgt) / max(np.sum(wgt), 1e-12))
    # pairs with zero valid rotation samples (unexcited links) carry no
    # consistency evidence either way: give them the MEDIAN valid misfit
    # (neutral) rather than the maximal pi penalty, so the proximity term
    # alone decides those edges instead of a fixed 180-deg handicap that
    # can outweigh lambda_prox for distant true neighbors
    if no_sample:
        iu = np.triu_indices(L, 1)
        sampled = [D[i, j] for i, j in zip(*iu) if (i, j) not in set(no_sample)]
        fill = float(np.median(sampled)) if sampled else np.pi
        for i, j in no_sample:
            D[i, j] = D[j, i] = fill
    return D


def motion_tree(
    cm_list,
    groups: list[set[int]],
    num_steps: int,
    lambda_prox: float = 1.5,
    interval: int = 4,
) -> list[LinkNode]:
    """Kinematic tree from single-revolute consistency + spatial proximity.

    The reference's tree is a proximity MST over cluster centers
    (coord_map.py:334-441, reproduced by :func:`cluster_mst` +
    :func:`kinematics_tree`), which mis-orders compact regions: on ur5 it
    wires forearm->wrist2->wrist1, making the forearm->wrist2 "joint" a
    two-revolute composite no estimator can fit.  Here the link-level MST
    weight is instead

        misfit_degrees(i, j) + lambda_prox * 100 * center_dist / bbox_diag

    so edges must BOTH look like a single revolute and be spatially
    plausible; the proximity term dominates only when consistency cannot
    discriminate (weakly excited joints).  Root selection and BFS ids
    reuse the reference scheme.
    """
    cm = cm_list[0]
    L = len(groups)
    D = revolute_consistency_matrix(cm_list, groups, num_steps, interval)
    centers = np.stack([
        cm.coords[:, sorted(g), :3].mean(axis=1).mean(axis=0) for g in groups
    ])
    P = np.linalg.norm(centers[:, None] - centers[None, :], axis=-1)
    W = np.degrees(D) + lambda_prox * 100.0 * P / max(cm.bbox_diag, 1e-9)

    mst_edges = minimum_spanning_edges(
        L, [(a, b, float(W[a, b])) for a in range(L) for b in range(a + 1, L)])

    # rebuild LinkNode adjacency from the motion MST, then the shared
    # root pick + BFS id assignment
    links = [LinkNode(id=i, cluster_idx=set(g)) for i, g in enumerate(groups)]
    for a, b in mst_edges:
        links[a].connected_links.add(b)
        links[b].connected_links.add(a)
    return _assign_tree_ids(links, cm)
