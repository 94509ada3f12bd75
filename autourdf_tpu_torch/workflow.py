"""Pipeline stages of the port (port of autourdf_tpu.workflow).

Only the registration stage is ported so far:

    register  data/raw/...  ->  data/part/.../{matrix,cluster}/*

with the reference's on-disk artifact layout, so each stage stays
resumable from disk.
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np
import torch

from . import resolve_device
from .config import PipelineConfig
from .io.artifacts import list_sequence_dirs, save_registration
from .io.ply import read_ply
from .ops.knn import PAD_COORD


def _sequence_dirs(raw_dir: str, num_videos: int) -> list[str]:
    """The simulated layout ``raw_dir/*`` or, when it is absent, the flat
    real-scan layout ``data/raw/{robot}/*/`` (frames ``*/robot.ply``)."""
    seq_dirs = list_sequence_dirs(raw_dir)[:num_videos]
    if not seq_dirs:
        parent = os.path.dirname(raw_dir)
        seq_dirs = [
            d for d in list_sequence_dirs(parent)
            if glob.glob(os.path.join(d, "*", "robot.ply"))
        ][:num_videos]
    if not seq_dirs:
        raise FileNotFoundError(f"no raw sequences under {raw_dir}")
    return seq_dirs


def _read_frames(seq_dir: str) -> list[np.ndarray]:
    frames = []
    for fd in sorted(glob.glob(os.path.join(seq_dir, "*/"))):
        ply = os.path.join(fd, "robot.ply")
        if os.path.exists(ply):
            frames.append(read_ply(ply))
    return frames


def load_raw_sequences(raw_dir: str, num_videos: int) -> tuple[list[str], np.ndarray]:
    """Read raw sequence dirs -> ``(names, (S, T, N, 3) frames)``."""
    seq_dirs = _sequence_dirs(raw_dir, num_videos)
    names = [os.path.basename(os.path.normpath(d)) for d in seq_dirs]
    return names, np.stack([np.stack(_read_frames(d)) for d in seq_dirs])


def load_raw_sequences_padded(
    raw_dir: str, num_videos: int
) -> tuple[list[str], np.ndarray, np.ndarray | None]:
    """Like :func:`load_raw_sequences` but tolerant of ragged frames.

    Real scans capture a different point count per frame.  Frames are
    sentinel-padded to the largest count and a boolean validity mask
    ``(S, T, N)`` is returned; uniform datasets return ``masks=None``.
    """
    seq_dirs = _sequence_dirs(raw_dir, num_videos)
    names = [os.path.basename(os.path.normpath(d)) for d in seq_dirs]
    raw = [_read_frames(d) for d in seq_dirs]
    lengths = {len(seq) for seq in raw}
    if len(lengths) > 1:
        # sequences with differing frame counts (an aborted capture):
        # truncate to the shortest rather than padding whole frames
        t_min = min(lengths)
        print(f"[load] warning: sequence lengths differ {sorted(lengths)}; "
              f"truncating all to {t_min} frames")
        raw = [seq[:t_min] for seq in raw]
    counts = {len(f) for seq in raw for f in seq}
    if len(counts) == 1:
        return names, np.stack([np.stack(seq) for seq in raw]), None
    n_max = max(counts)
    S, T = len(raw), len(raw[0])
    frames = np.full((S, T, n_max, 3), PAD_COORD, np.float32)
    masks = np.zeros((S, T, n_max), bool)
    for s, seq in enumerate(raw):
        for t, f in enumerate(seq):
            frames[s, t, : len(f)] = f
            masks[s, t, : len(f)] = True
    return names, frames, masks


def run_registration(
    cfg: PipelineConfig,
    seed: int = 0,
    mlp_icp: bool = False,
    use_normals: bool = False,
    corr_every: int = 1,
    verbose: bool = True,
    device: str | torch.device = "cuda",
) -> dict:
    """Register all sequences in one batch on ``device``; save artifacts.

    The frame-0 segmentation and the initial MLP weights are drawn from
    ``torch.Generator``s seeded with ``seed`` and ``seed + 1``.  Returns
    run statistics and, under ``"result"``, the device-resident
    :class:`~autourdf_tpu_torch.registration.SequenceResult`.
    """
    from .models.regmlp import PoseRegressor
    from .registration import RegistrationConfig, initial_segments, register_sequences_batched

    dev = resolve_device(device)
    names, frames, masks = load_raw_sequences_padded(cfg.raw_dir(), cfg.num_videos)
    S, T, N, _ = frames.shape
    K = cfg.num_segments()
    if verbose:
        print(f"[register] {S} sequences x {T} frames x {N} points, K={K}, "
              f"mode={cfg.rot}, device={dev}"
              + (" (ragged, masked)" if masks is not None else ""))
    if corr_every > 1 and cfg.epochs % corr_every:
        raise ValueError(
            f"--epochs {cfg.epochs} must be a multiple of --corr-every {corr_every}")
    reg_cfg = RegistrationConfig(num_seg=K, mode=cfg.rot, epochs=cfg.epochs, mlp_icp=mlp_icp,
                                 use_normals=use_normals, corr_every=corr_every)

    frames_t = torch.from_numpy(frames).to(dev)
    masks_t = torch.from_numpy(masks).to(dev) if masks is not None else None
    gen = torch.Generator(device=dev).manual_seed(seed)
    init = initial_segments(gen, frames_t[0, 0], K, n_init=10, seed_mode=cfg.seed_mode,
                            use_normals=use_normals,
                            mask=masks_t[0, 0] if masks_t is not None else None)

    # one MLP per sequence and phase; weights drawn on the CPU from the seed
    wgen = torch.Generator().manual_seed(seed + 1)
    model = PoseRegressor(cfg.rot, 512, num_seqs=S, generator=wgen, device=dev)
    step_params = {k: v.detach() for k, v in model.named_parameters()}
    anchor_params = {k: v.detach() for k, v in PoseRegressor(
        cfg.rot, 512, num_seqs=S, generator=wgen, device=dev).named_parameters()}

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    result = register_sequences_batched(model, reg_cfg, step_params, anchor_params, init,
                                        frames_t, masks_t)
    all_matrices = result.matrices.cpu().numpy()   # waits for the device
    elapsed = time.time() - t0
    frames_registered = S * (T - 1)
    if verbose:
        print(f"[register] {elapsed:.2f}s for {frames_registered} frame pairs "
              f"({frames_registered / elapsed:.2f} frames/s)")

    all_points = result.local_points.cpu().numpy()
    all_labels = result.labels.cpu().numpy()
    all_losses = result.losses.cpu().numpy()
    all_step_losses = result.step_losses.cpu().numpy()
    for s, name in enumerate(names):
        lp, lb = all_points[s], all_labels[s]
        if masks is not None:
            # drop sentinel-padded rows.  Frame 0 of EVERY sequence is the
            # shared init (sequence 0's frame-0 segmentation), so its rows
            # follow the init's own mask
            row_mask = [masks[0, 0]] + [masks[s, t] for t in range(1, lp.shape[0])]
            lp = [lp[t][row_mask[t]] for t in range(lp.shape[0])]
            lb = [lb[t][row_mask[t]] for t in range(len(lb))]
        save_registration(os.path.join(cfg.part_dir(), name), all_matrices[s], lp, lb,
                          all_losses[s])
    return {
        "names": names,
        "device": str(dev),
        "seconds": elapsed,
        "frames_per_second": frames_registered / elapsed,
        "final_losses": all_losses[:, -1].tolist(),
        "mean_loss": float(np.mean(all_losses)),
        "mean_step_loss": float(np.mean(all_step_losses)),
        "result": result,
    }
