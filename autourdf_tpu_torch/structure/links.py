"""Link consolidation: merge member clusters into per-link frames + clouds
(port of autourdf_tpu.structure.links).

Rebuilds the reference's cluster_to_link, save_links and
refine_links_clusters: per link per step, the link frame is (mean member
xyz, eigen-averaged member quaternion); member points map to world and back
into the link frame; then every step's link-local cloud is ICP-aligned to
step 0's (all links of a step as one batched ICP on the device) and
accumulated into a dense canonical cloud per link for meshing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core.quat_np import mean_link_frame_np
from ..io.artifacts import save_cluster_npz
from ..ops.icp import icp_point_to_point
from .coord_map import CoordMap


@dataclass
class LinkArtifacts:
    matrices: np.ndarray           # (T, L, 4, 4) link frames per step
    clusters: list[list[np.ndarray]]   # [T][L] link-local point clouds
    clusters_wf: list[list[np.ndarray]]  # [T][L] world-frame clouds
    refined: list[list[np.ndarray]] | None = None  # [T][L] step->0 aligned


def link_frame(cm: CoordMap, members: list[int], t: int) -> np.ndarray:
    """(4, 4) link frame at step t: mean xyz + eigen-average quaternion."""
    return mean_link_frame_np(cm.coords[t, members, :])


def consolidate_links(cm: CoordMap, groups: list[set[int]]) -> LinkArtifacts:
    T_steps = cm.coords.shape[0]
    L = len(groups)
    matrices = np.zeros((T_steps, L, 4, 4))
    clusters: list[list[np.ndarray]] = [[None] * L for _ in range(T_steps)]
    clusters_wf: list[list[np.ndarray]] = [[None] * L for _ in range(T_steps)]
    for li, group in enumerate(groups):
        members = sorted(group)
        for t in range(T_steps):
            Tl = link_frame(cm, members, t)
            matrices[t, li] = Tl
            pts = np.asarray(cm.cluster_points[t])
            labels = np.asarray(cm.cluster_labels[t])
            world_parts = []
            for m in members:
                sel = labels == m
                M = cm.matrices[t, m]
                world_parts.append(pts[sel] @ M[:3, :3].T + M[:3, 3])
            wf = np.concatenate(world_parts, axis=0) if world_parts else np.zeros((0, 3))
            inv = np.linalg.inv(Tl)
            lf = wf @ inv[:3, :3].T + inv[:3, 3]
            clusters[t][li] = lf
            clusters_wf[t][li] = wf
    return LinkArtifacts(matrices, clusters, clusters_wf)


def refine_link_clusters(
    art: LinkArtifacts,
    max_iterations: int = 50,
    threshold: float = 1.0,
    device: str | torch.device = "cuda",
) -> LinkArtifacts:
    """ICP-align every step's link-local cloud onto step 0's, batched.

    The reference runs one Open3D ICP per link per step; here all links of
    a step are one batched ICP over point sets padded to the largest link
    cloud (masked), run on ``device``.
    """
    T_steps = len(art.clusters)
    L = len(art.clusters[0])
    p_max = max(len(art.clusters[t][l]) for t in range(T_steps) for l in range(L))

    def pad_step(t):
        pts = np.zeros((L, p_max, 3), np.float32)
        mask = np.zeros((L, p_max), bool)
        for l, c in enumerate(art.clusters[t]):
            pts[l, : len(c)] = c
            mask[l, : len(c)] = True
        return torch.from_numpy(pts).to(device), torch.from_numpy(mask).to(device)

    ref_pts, ref_masks = pad_step(0)
    refined: list[list[np.ndarray]] = [[c.copy() for c in art.clusters[0]]]
    for t in range(1, T_steps):
        src_pts, src_masks = pad_step(t)
        Ts = icp_point_to_point(
            src_pts, ref_pts, max_iterations=max_iterations, threshold=threshold,
            source_mask=src_masks, target_mask=ref_masks,
        ).transform.cpu().numpy()
        refined.append([c @ Ts[l][:3, :3].T + Ts[l][:3, 3]
                        for l, c in enumerate(art.clusters[t])])
    return LinkArtifacts(art.matrices, art.clusters, art.clusters_wf, refined)


def canonical_link_clouds(art: LinkArtifacts) -> list[np.ndarray]:
    """Accumulate refined steps per link (the reference's {i:04}.ply clouds)."""
    L = len(art.clusters[0])
    source = art.refined if art.refined is not None else art.clusters
    return [
        np.concatenate([source[t][l] for t in range(len(source))], axis=0)
        for l in range(L)
    ]


def save_link_artifacts(link_dir: str, art: LinkArtifacts) -> None:
    """Persist the reference's mesh-stage layout."""
    os.makedirs(os.path.join(link_dir, "matrix"), exist_ok=True)
    os.makedirs(os.path.join(link_dir, "cluster"), exist_ok=True)
    os.makedirs(os.path.join(link_dir, "cluster_wf"), exist_ok=True)
    if art.refined is not None:
        os.makedirs(os.path.join(link_dir, "cluster_rf"), exist_ok=True)
    for t in range(len(art.clusters)):
        np.save(os.path.join(link_dir, "matrix", f"{t:04}.npy"), art.matrices[t])
        save_cluster_npz(os.path.join(link_dir, "cluster", f"{t:04}.npz"), art.clusters[t])
        save_cluster_npz(os.path.join(link_dir, "cluster_wf", f"{t:04}.npz"), art.clusters_wf[t])
        if art.refined is not None:
            save_cluster_npz(os.path.join(link_dir, "cluster_rf", f"{t:04}.npz"), art.refined[t])
