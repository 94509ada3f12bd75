"""Pipeline stages of the port (port of autourdf_tpu.workflow).

Two stages are ported so far:

    register  data/raw/...   ->  data/part/.../{matrix,cluster}/*
    urdf      data/part/...  ->  data/mesh/... + data/urdf/...
              (structure -> joints -> link meshes -> URDF file), in its
              reference-parity configuration ``refine="none"``

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
from .config import PipelineConfig, get_robot
from .io.artifacts import list_sequence_dirs, load_registration, save_registration
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


def build_coord_maps(cfg: PipelineConfig, num_videos: int | None = None,
                     start: int = 0, end: int | None = None):
    """One :class:`~autourdf_tpu_torch.structure.CoordMap` per sequence from
    the ``part/`` artifacts and the raw clouds: ``(coord maps, part dirs)``."""
    from .structure import CoordMap

    n = num_videos or cfg.num_videos
    part_dirs = list_sequence_dirs(cfg.part_dir())[:n]
    raw_dirs = list_sequence_dirs(cfg.raw_dir())[:n]
    if not raw_dirs:
        raw_dirs = _sequence_dirs(cfg.raw_dir(), n)   # flat real-scan layout
    cms = []
    for pd, rd in zip(part_dirs, raw_dirs):
        art = load_registration(pd, start, end)
        cms.append(CoordMap.from_arrays(art.matrices, art.cluster_points, art.cluster_labels,
                                        _read_frames(rd)))
    return cms, part_dirs


def _load_refine_frames(cfg: PipelineConfig, end_video: int | None):
    """Raw frames + masks sliced to the build window."""
    _, frames, fmasks = load_raw_sequences_padded(cfg.raw_dir(), end_video or cfg.num_videos)
    frames = frames[:, cfg.start_steps:cfg.end_steps]
    if fmasks is not None:
        fmasks = fmasks[:, cfg.start_steps:cfg.end_steps]
    return frames, fmasks


_CHAIN_ITEM = "ROADMAP.md Queue 1 item 9: the chain fit, joints/chain.py"


def run_build_urdf(
    cfg: PipelineConfig,
    unknown_dof: bool = True,
    dist_mode: str = "pose",
    dof_method: str = "auto",
    end_video: int | None = None,
    refine: str = "chain",
    refine_steps: int = 1200,
    chain_balance: bool = False,
    canonical_frames: int = 1,
    chain_anchors: int = 1,
    chain_trunc: float = 0.0,
    tree: str = "motion",
    reassign: bool = True,
    dof_guard: bool = True,
    dof_probe: bool = True,
    dof_probe_steps: int = 60,
    dof_probe_points: int = 256,
    ladder_share_norm: bool = True,
    freeze_prune: float = 0.25,
    prune_deg: float = 2.0,
    drift_prune: bool = False,
    drift_theta_deg: float = 12.0,
    drift_conc: float = 0.85,
    drift_spread_deg: float = 45.0,
    coart_merge: bool = True,
    verbose: bool = True,
    device: str | torch.device = "cuda",
) -> dict:
    """Structure discovery -> joints -> link meshes -> URDF file.

    The signature is that of ``autourdf_tpu.workflow.run_build_urdf`` plus
    ``device`` (where the carry test and the link ICP run their
    nearest-neighbour searches).  Ported so far is the reference-parity
    configuration: ``refine="none"``, with ``tree="mst"`` or a
    ``tree="motion"`` that agrees with the proximity MST, and either the
    registry's known DoF or ``unknown_dof=True, dof_probe=False`` (the
    dendrogram search with the carry-test reassignment and the rigidity
    guard).  What needs the kinematic-chain fit raises
    ``NotImplementedError``: ``refine="chain"`` (the default, so a default
    call raises until the chain fit is ported; the ``refine_steps`` ...
    ``coart_merge`` arguments belong to it), ``dof_probe`` with
    ``unknown_dof`` (the probe ladder), and the arbitration between a
    motion tree and an MST that disagree.
    """
    if refine == "chain":
        raise NotImplementedError(
            f"refine='chain' is not ported yet ({_CHAIN_ITEM}); pass refine='none' for the "
            "reference-parity build")
    if refine != "none":
        raise ValueError(f"unknown refine mode {refine!r}")
    if unknown_dof and dof_probe:
        raise NotImplementedError(
            "the unknown-DoF probe ladder is not ported yet (ROADMAP.md Queue 1 item 8: "
            "structure/model_select.py, which needs the chain fit of item 9); pass "
            "dof_probe=False")
    from .joints import estimate_joints_from_tree
    from .mesh import generate_link_meshes
    from .structure import (
        auto_dof_search,
        canonical_link_clouds,
        cluster_mst,
        combined_sum_map,
        consolidate_links,
        coord_clustering,
        kinematics_tree,
        merge_gap_dof_search,
        motion_tree,
        refine_groups_by_carry,
        refine_link_clusters,
        rigidity_guarded_groups,
        save_link_artifacts,
        silhouette_dof_search,
        swap_consistency_stack,
    )
    from .urdf.writer import write_urdf

    dev = resolve_device(device)
    cms, part_dirs = build_coord_maps(cfg, end_video, cfg.start_steps, cfg.end_steps)
    sum_map = combined_sum_map(cms, dist_mode, device=dev)

    if unknown_dof:
        search = {"gap": merge_gap_dof_search, "silhouette": silhouette_dof_search,
                  "auto": auto_dof_search}[dof_method]
        groups, labels, scores, nls = search(sum_map)
        dof = len(groups) - 1
        if verbose:
            print(f"[urdf] {dof_method} DoF search: links={len(groups)} dof={dof}")
        score_dir = os.path.join(part_dirs[0], "score")
        os.makedirs(score_dir, exist_ok=True)
        with open(os.path.join(score_dir, "silhouette_score.txt"), "w") as f:
            f.write(f"Silhouette Score: {scores}\n")
            f.write(f"Number of Links: {nls.tolist()}\n")
    else:
        dof = get_robot(cfg.robot).dof
        groups, labels, _ = coord_clustering(sum_map, dof + 1)

    carry_stack = None
    if reassign or (unknown_dof and dof_guard):
        carry_stack = swap_consistency_stack(cms, device=dev)
    if reassign:
        groups = refine_groups_by_carry(cms, groups, verbose=verbose, stack=carry_stack)
        dof = len(groups) - 1
    if unknown_dof and dof_guard:
        groups, fired = rigidity_guarded_groups(sum_map, carry_stack, groups, verbose=verbose)
        if fired:
            dof = len(groups) - 1
            if verbose:
                print(f"[urdf] rigidity guard escalated: links={len(groups)} dof={dof}")

    num_steps = cfg.end_steps - cfg.start_steps
    if tree == "motion":
        links = motion_tree(cms, groups, num_steps)
        links_mst = kinematics_tree(cms[0], groups, cluster_mst(cms[0]))

        def _edges(ls):
            return {frozenset((l.id, l.parent_id)) for l in ls if l.parent_id is not None}

        if _edges(links_mst) != _edges(links):
            raise NotImplementedError(
                "the motion tree and the proximity MST disagree, and arbitrating them needs "
                f"a chain-fit probe that is not ported yet ({_CHAIN_ITEM}); pass tree='mst'")
    else:
        links = kinematics_tree(cms[0], groups, cluster_mst(cms[0]))
    # cms are already sliced to [start_steps:end_steps]; index them 0-based
    joints = estimate_joints_from_tree(links, cms, 0, num_steps, interval=4)

    # link artifacts + meshes from the first sequence only.  Order by link
    # id: the URDF writer references {id:04}.stl, while the tree list is in
    # BFS order -- mixing the two scrambles mesh assignment.
    links_by_id = sorted(links, key=lambda l: l.id)
    art = consolidate_links(cms[0], [l.cluster_idx for l in links_by_id])
    art = refine_link_clusters(art, device=dev)
    seq_name = os.path.basename(os.path.normpath(part_dirs[0]))
    link_dir = os.path.join(cfg.mesh_dir(), seq_name)
    save_link_artifacts(link_dir, art)
    clouds = canonical_link_clouds(art)
    mesh_paths = generate_link_meshes(clouds, link_dir, cfg.voxel())

    urdf_path = write_urdf(links, joints, cms[0], cfg.urdf_path(), mesh_dir=link_dir,
                           robot_name=f"estimated_{cfg.robot}")
    if verbose:
        print(f"[urdf] wrote {urdf_path} ({len(links)} links, {len(joints)} joints)")
    return {
        "urdf_path": urdf_path,
        "num_links": len(links),
        "dof": dof,
        "mesh_paths": mesh_paths,
        "links": links,
        "joints": joints,
    }
