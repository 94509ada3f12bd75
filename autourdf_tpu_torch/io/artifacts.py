"""Stage artifact store — the file-system API between pipeline stages.

The reference's stages communicate exclusively through ``data/...`` files
(SURVEY: matrix/{t:04}.npy (K,4,4) + cluster/{t:04}.npz ragged per-cluster
arrays, written by the reference's PointCloud/mlp_reg.py).  Copy of
autourdf_tpu.io.artifacts: numpy only, kept here so the port imports
nothing of the JAX package.  We keep
that exact on-disk contract (stage-resumable, reference-compatible) while
the in-memory form stays dense: flat points + labels.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass

import numpy as np


def save_cluster_npz(path: str, clusters: list[np.ndarray]) -> None:
    """Ragged per-cluster arrays keyed '0'..'K-1' (insertion ordered)."""
    np.savez(path, **{str(i): c for i, c in enumerate(clusters)})


def load_cluster_npz(path: str) -> list[np.ndarray]:
    with np.load(path) as z:
        return [z[k] for k in z.files]


def split_by_labels(
    points: np.ndarray, labels: np.ndarray, num_clusters: int
) -> list[np.ndarray]:
    return [points[labels == k] for k in range(num_clusters)]


def flatten_clusters(clusters: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    points = np.concatenate(clusters, axis=0)
    labels = np.concatenate(
        [np.full(len(c), k, np.int32) for k, c in enumerate(clusters)]
    )
    return points, labels


@dataclass
class SequenceArtifacts:
    matrices: np.ndarray                 # (T, K, 4, 4)
    cluster_points: list[np.ndarray]     # T x (N_t, 3) flat local points
    cluster_labels: list[np.ndarray]     # T x (N_t,)
    num_clusters: int
    losses: np.ndarray | None = None


def save_registration(
    save_dir: str,
    matrices: np.ndarray,
    local_points: np.ndarray,
    labels: np.ndarray,
    losses: np.ndarray | None = None,
) -> None:
    """Write a registered sequence in the reference's part-artifact layout."""
    os.makedirs(os.path.join(save_dir, "matrix"), exist_ok=True)
    os.makedirs(os.path.join(save_dir, "cluster"), exist_ok=True)
    k = matrices.shape[1]
    for t in range(matrices.shape[0]):
        np.save(os.path.join(save_dir, "matrix", f"{t:04}.npy"), matrices[t])
        save_cluster_npz(
            os.path.join(save_dir, "cluster", f"{t:04}.npz"),
            split_by_labels(np.asarray(local_points[t]), np.asarray(labels[t]), k),
        )
    if losses is not None:
        np.savetxt(os.path.join(save_dir, "loss.txt"), np.asarray(losses))


def load_registration(save_dir: str, start: int = 0, end: int | None = None) -> SequenceArtifacts:
    m_files = sorted(glob.glob(os.path.join(save_dir, "matrix", "*.npy")))
    c_files = sorted(glob.glob(os.path.join(save_dir, "cluster", "*.npz")))
    m_files = m_files[start:end]
    c_files = c_files[start:end]
    matrices = np.stack([np.load(f) for f in m_files])
    pts, labs = [], []
    for f in c_files:
        clusters = load_cluster_npz(f)
        p, l = flatten_clusters(clusters)
        pts.append(p)
        labs.append(l)
    loss_path = os.path.join(save_dir, "loss.txt")
    losses = np.loadtxt(loss_path) if os.path.exists(loss_path) else None
    return SequenceArtifacts(matrices, pts, labs, matrices.shape[1], losses)


def list_sequence_dirs(parent: str) -> list[str]:
    return sorted(
        d for d in glob.glob(os.path.join(parent, "*")) if os.path.isdir(d)
    )
