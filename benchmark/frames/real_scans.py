"""The tracked real scans: ``data_root/raw/<robot>`` links to the repo's
directory, the flat real-scan layout ``<robot>/V000k/000t/robot.ply`` that
``cli register`` falls back to.  A test's ``tiny_frames`` override writes a
cut copy instead (sequences, frames and points a frame)."""

from __future__ import annotations

import os

import numpy as np

from ..plyio import read_sequences, write_ply


def make(run, data_root: str) -> list[str]:
    cfg = run.cell.config
    src = os.path.join(run.cell.root, cfg["frames"]["dir"])
    seqs = sorted(d for d in os.listdir(src) if os.path.isdir(os.path.join(src, d)))
    seqs = seqs[:cfg["sequences"]]
    dst = os.path.join(data_root, "raw", cfg["robot"])
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    tiny = run.overrides.get("tiny_frames")
    if tiny is None:
        os.symlink(os.path.abspath(src), dst)
        return [os.path.join(dst, s) for s in seqs]
    n_seq, n_frames, n_points = tiny
    frames = read_sequences([os.path.join(src, s) for s in seqs[:n_seq]])
    out = []
    for s, seq in zip(seqs, frames):
        for t, f in enumerate(seq[:n_frames]):
            # ragged, as the real scans are: a few points fewer in odd frames
            keep = n_points - (t % 2) * max(1, n_points // 50)
            idx = np.linspace(0, len(f) - 1, keep).astype(np.int64)
            write_ply(os.path.join(dst, s, f"{t:04}", "robot.ply"), f[idx])
        out.append(os.path.join(dst, s))
    return out
