"""Pipeline stages of the port (port of autourdf_tpu.workflow).

    dataset   -> data/raw/...        (sim.datagen.collect: capture on the card)
    register  data/raw/...   ->  data/part/.../{matrix,cluster}/*
    urdf      data/part/...  ->  data/mesh/... + data/urdf/...
              (structure -> joints -> kinematic-chain fit -> link meshes
              -> URDF file), with the JAX package's defaults
    evaluate  -> data/evaluation/... (eval.joints_eval + eval.resim, with the
              gt-vs-gt floor)

with the reference's on-disk artifact layout, so each stage stays
resumable from disk.  Every stage appends its record to
``{data_root}/telemetry.json``, as the JAX stages do.
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
from .utils.telemetry import Telemetry


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


def _telemetry(cfg: PipelineConfig) -> Telemetry:
    return Telemetry(path=os.path.join(cfg.data_root, "telemetry.json"))


def run_dataset(cfg: PipelineConfig, asset_root: str | None = None,
                ground: bool = False, epochs: int = 5,
                device: str | torch.device = "cuda") -> list[str]:
    """Simulate ``epochs`` collision-free sequences of ``cfg.robot`` into
    ``cfg.raw_dir()``, capturing on ``device``; returns their dirs."""
    from .sim.datagen import collect

    dev = resolve_device(device)
    with _telemetry(cfg).stage("dataset", robot=cfg.robot, epochs=epochs):
        return collect(cfg, asset_root=asset_root, ground=ground, epochs=epochs, device=dev)


def _draw_weights(num_seqs: int, seed: int, device: str | torch.device = "cuda",
                  mode: str = "q", hidden_dim: int = 512):
    """The registration's initial MLPs: ``(model, step_params,
    anchor_params)``, one MLP a sequence and phase, drawn on the CPU from a
    ``torch.Generator`` seeded ``seed + 1`` (the step MLPs first), so a seed
    gives the same weights on every machine; then moved to ``device``."""
    from .models.regmlp import PoseRegressor

    wgen = torch.Generator().manual_seed(seed + 1)
    model = PoseRegressor(mode, hidden_dim, num_seqs=num_seqs, generator=wgen, device=device)
    step_params = {k: v.detach() for k, v in model.named_parameters()}
    anchor_params = {k: v.detach() for k, v in PoseRegressor(
        mode, hidden_dim, num_seqs=num_seqs, generator=wgen, device=device).named_parameters()}
    return model, step_params, anchor_params


def registration_inputs(cfg: PipelineConfig, seed: int = 0, mlp_icp: bool = False,
                        use_normals: bool = False, corr_every: int = 1,
                        device: str | torch.device = "cuda") -> dict:
    """What :func:`run_registration` hands the driver: the raw sequences
    (sentinel-padded, with masks when ragged) on ``device``, the
    ``RegistrationConfig`` (its ``dispatch_epochs`` from the frame size, as
    the JAX workflow sets it), the frame-0 segmentation drawn from a
    ``torch.Generator`` seeded with ``seed`` and the MLP weights from
    ``seed + 1``."""
    from .registration import RegistrationConfig, initial_segments

    dev = resolve_device(device)
    names, frames, masks = load_raw_sequences_padded(cfg.raw_dir(), cfg.num_videos)
    S, T, N, _ = frames.shape
    K = cfg.num_segments()
    if corr_every > 1 and cfg.epochs % corr_every:
        raise ValueError(
            f"--epochs {cfg.epochs} must be a multiple of --corr-every {corr_every}")
    # the epochs of one training program: 100 up to 5,000 points a frame,
    # fewer above (the JAX workflow's rule, there to keep one TPU execution
    # near its 5,000-point duration; here it sets the graphs' chunk)
    dispatch = int(np.clip(100 * (5000.0 / max(N, 1)) ** 2, 25, 100))
    reg_cfg = RegistrationConfig(num_seg=K, mode=cfg.rot, epochs=cfg.epochs, mlp_icp=mlp_icp,
                                 use_normals=use_normals, corr_every=corr_every,
                                 dispatch_epochs=dispatch)
    frames_t = torch.from_numpy(frames).to(dev)
    masks_t = torch.from_numpy(masks).to(dev) if masks is not None else None
    gen = torch.Generator(device=dev).manual_seed(seed)
    init = initial_segments(gen, frames_t[0, 0], K, n_init=10, seed_mode=cfg.seed_mode,
                            use_normals=use_normals,
                            mask=masks_t[0, 0] if masks_t is not None else None)
    model, step_params, anchor_params = _draw_weights(S, seed, dev, cfg.rot)
    return dict(names=names, masks=masks, device=dev, reg_cfg=reg_cfg, model=model,
                step_params=step_params, anchor_params=anchor_params, init=init,
                frames=frames_t, frame_masks=masks_t)


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

    The inputs are :func:`registration_inputs`'; the driver is
    ``register_sequences_batched`` (its phase programs: CUDA graphs on the
    card).  Returns run statistics and, under ``"result"``, the
    device-resident :class:`~autourdf_tpu_torch.registration.SequenceResult`.
    """
    from .registration import register_sequences_batched

    inp = registration_inputs(cfg, seed, mlp_icp, use_normals, corr_every, device)
    dev, names, masks = inp["device"], inp["names"], inp["masks"]
    S, T, N, _ = inp["frames"].shape
    if verbose:
        print(f"[register] {S} sequences x {T} frames x {N} points, "
              f"K={inp['reg_cfg'].num_seg}, mode={cfg.rot}, device={dev}"
              + (" (ragged, masked)" if masks is not None else ""))

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    result = register_sequences_batched(inp["model"], inp["reg_cfg"], inp["step_params"],
                                        inp["anchor_params"], inp["init"], inp["frames"],
                                        inp["frame_masks"])
    all_matrices = result.matrices.cpu().numpy()   # waits for the device
    elapsed = time.time() - t0
    frames_registered = S * (T - 1)
    if verbose:
        print(f"[register] {elapsed:.2f}s for {frames_registered} frame pairs "
              f"({frames_registered / elapsed:.2f} frames/s)")
    with _telemetry(cfg).stage("register", robot=cfg.robot, frames=frames_registered,
                               seconds_compute=round(elapsed, 3)):
        pass

    all_losses = result.losses.cpu().numpy()
    all_step_losses = result.step_losses.cpu().numpy()
    _save_registrations(cfg, names, all_matrices, result.local_points.cpu().numpy(),
                        result.labels.cpu().numpy(), all_losses, masks)
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


def _save_registrations(cfg: PipelineConfig, names: list[str], matrices: np.ndarray,
                        local_points: np.ndarray, labels: np.ndarray, losses: np.ndarray,
                        masks: np.ndarray | None) -> None:
    """Write a batched registration's ``(S, T, ...)`` arrays as one part
    directory a sequence under ``cfg.part_dir()``, valid rows only."""
    for s, name in enumerate(names):
        lp, lb = local_points[s], labels[s]
        if masks is not None:
            # drop sentinel-padded rows.  Frame 0 of EVERY sequence is the
            # shared init (sequence 0's frame-0 segmentation), so its rows
            # follow the init's own mask
            row_mask = [masks[0, 0]] + [masks[s, t] for t in range(1, lp.shape[0])]
            lp = [lp[t][row_mask[t]] for t in range(lp.shape[0])]
            lb = [lb[t][row_mask[t]] for t in range(len(lb))]
        save_registration(os.path.join(cfg.part_dir(), name), matrices[s], lp, lb, losses[s])


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


def _select_tree_by_chain_fit(candidates: dict, cms, frames, fmasks,
                              num_steps: int, verbose: bool,
                              probe_steps: int = 100,
                              device: str | torch.device = "cuda"):
    """Pick the tree whose 1-DoF-per-edge chain model best fits the raw
    clouds (a short probe fit per candidate, on ``device``; see
    run_build_urdf)."""
    from .joints import estimate_joints_from_tree
    from .joints.chain import refine_chain, short_fit_dispatch

    best_name, best_links, best_loss = None, None, np.inf
    for name, links in candidates.items():
        joints = estimate_joints_from_tree(links, cms, 0, num_steps, interval=4)
        if not joints:
            loss = np.inf
        else:
            _, result = refine_chain(links, joints, cms, frames,
                                     steps=probe_steps, points_per_link=1024,
                                     frame_masks=fmasks, device=device,
                                     dispatch_steps=short_fit_dispatch(probe_steps))
            loss = float(result.loss)
        if verbose:
            print(f"[urdf] tree candidate {name}: probe chain loss {loss:.5f}")
        if loss < best_loss:
            best_name, best_links, best_loss = name, links, loss
    if best_links is None:
        # every candidate produced zero joints (all probe losses inf): take
        # the first candidate (proximity MST) so downstream gets a tree;
        # joint estimation then surfaces the real failure
        best_name = next(iter(candidates))
        best_links = candidates[best_name]
        if verbose:
            print("[urdf] WARNING: no tree candidate yielded joints; "
                  f"falling back to {best_name}")
    if verbose:
        print(f"[urdf] selected {best_name} tree")
    return best_links


def _refine_chain_loop(links, joints, cms, refine_frames, num_steps: int, dof: int, *,
                       refine_steps: int, chain_balance: bool, canonical_frames: int,
                       chain_anchors: int, chain_trunc: float, freeze_prune: float,
                       prune_deg: float, drift_prune: bool, drift_theta_deg: float,
                       drift_conc: float, drift_spread_deg: float, coart_merge: bool,
                       verbose: bool, device: torch.device):
    """The ``refine="chain"`` block of run_build_urdf: fit -> veto -> prune
    -> REFIT, until a pass prunes nothing.  Returns ``(links, joints, dof)``.

    Merging a vetoed joint changes the structure, and the next pass re-fits
    and RE-PROBES the merged structure: the freeze-delta of a remaining
    joint can only drop below threshold once a neighbouring spurious
    joint's drift absorption is gone.  Bounded: every pass past the first
    must have pruned at least one joint; clean discoveries exit after one
    fit (plus the J forward evaluations of the freeze probe).
    """
    from .joints import estimate_joints_from_tree, joint_screw_coherence
    from .joints.chain import (merge_coarticulated_siblings, prune_static_joints,
                               refine_chain_multi_anchor)

    frames, fmasks = refine_frames
    # workload scale for the coarticulation line-coincidence gate: diagonal
    # of the first observed frame cloud
    _f0 = frames[0, 0][np.asarray(fmasks[0, 0], bool)] if fmasks is not None else frames[0, 0]
    cloud_scale = float(np.linalg.norm(_f0.max(axis=0) - _f0.min(axis=0)))
    for _veto_pass in range(8):
        joints, chain_res = refine_chain_multi_anchor(
            links, joints, cms, frames, anchors=chain_anchors, steps=refine_steps,
            points_per_link=1024, frame_masks=fmasks, balance=chain_balance,
            canonical_frames=canonical_frames, trunc=chain_trunc, verbose=verbose,
            device=device,
        )
        # per-joint articulation diagnostics: fitted theta range from the
        # chain fit + screw-sample axis coherence from the registration.
        # The drift veto combines both: a joint BOTH weakly excited and
        # axis-incoherent is registration drift, not articulation.
        th = chain_res.thetas
        ranges = np.degrees((th.max(axis=1) - th.min(axis=1)).max(axis=0))
        coh = joint_screw_coherence(links, cms, 0, num_steps, interval=4)
        fdel = chain_res.freeze_deltas
        fshare = chain_res.subtree_share
        if verbose:
            for j, (joint, c) in enumerate(zip(joints, coh)):
                fd = ""
                if fdel is not None:
                    fd = f" freeze {fdel[j] * 100:.1f}%"
                    if fshare is not None and fshare[j] > 0:
                        # share-normalized: delta per unit movable mass
                        fd += f" (norm {fdel[j] / fshare[j] * 100:.0f}%)"
                print(f"[prune-diag] joint {joint.parent_link}->"
                      f"{joint.child_link}: theta_range {ranges[j]:.1f}deg "
                      f"conc {c.concentration:.3f} "
                      f"spread {c.seq_spread_deg:.1f}deg "
                      f"total {c.total_angle_deg:.0f}deg{fd}", flush=True)
        drift_static: list[int] = []
        if drift_prune:
            for j, c in enumerate(coh):
                incoherent = (c.concentration < drift_conc
                              or (np.isfinite(c.seq_spread_deg)
                                  and c.seq_spread_deg > drift_spread_deg))
                if ranges[j] < drift_theta_deg and incoherent:
                    drift_static.append(j)
                    if verbose:
                        print(f"[urdf] drift veto: joint {joints[j].parent_link}->"
                              f"{joints[j].child_link} (range {ranges[j]:.1f}deg, "
                              f"conc {c.concentration:.3f}, "
                              f"spread {c.seq_spread_deg:.1f}deg)", flush=True)
        if freeze_prune > 0 and fdel is not None:
            # freeze-delta veto: a joint whose fitted motion buys less
            # chamfer than ``freeze_prune`` of its subtree's point share is a
            # symmetry-flat / drift direction, not articulation (spurious
            # joints read 2-16% normalized, real joints >= 55%; 0.25 sits at
            # the geometric midpoint of the gap)
            for j in range(len(joints)):
                if j in drift_static:
                    continue
                norm = (fdel[j] / max(float(fshare[j]), 1e-6)
                        if fshare is not None else fdel[j])
                if norm < freeze_prune:
                    drift_static.append(j)
                    if verbose:
                        print(f"[urdf] freeze veto: joint {joints[j].parent_link}->"
                              f"{joints[j].child_link} (freeze {fdel[j] * 100:.1f}%, "
                              f"norm {norm * 100:.0f}% < {freeze_prune * 100:.0f}%)",
                              flush=True)
        pruned = False
        if prune_deg > 0 or drift_static:
            links, pruned = prune_static_joints(
                links, joints, chain_res.thetas,
                threshold=np.radians(prune_deg) if prune_deg > 0 else 0.0,
                extra_static=drift_static)
        if not pruned and coart_merge:
            # per-joint vetoes exhausted: the PAIRWISE signal, sibling
            # joints tracking one physical hinge
            links, pruned = merge_coarticulated_siblings(
                links, joints, chain_res.thetas, scale=cloud_scale, verbose=verbose)
            if pruned and verbose:
                print("[urdf] coarticulation merge: sibling links share one hinge", flush=True)
        if not pruned:
            break
        # membership changed -> link frames changed; redo the estimate,
        # then loop back for the refit + re-probe
        dof = len(links) - 1
        if verbose:
            print(f"[urdf] pruned static joint(s): links={len(links)} dof={dof}")
        joints = estimate_joints_from_tree(links, cms, 0, num_steps, interval=4)
        if not joints:
            break
    return links, joints, dof


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

    The signature and defaults are those of
    ``autourdf_tpu.workflow.run_build_urdf`` plus ``device``, where every
    search runs (the carry test, the chain fits, the link ICP).

    ``refine="chain"`` (default) runs the global kinematic-chain fit
    against the raw frames after the screw estimate, in a fit -> veto ->
    prune -> refit loop (the freeze-delta veto ``freeze_prune``, the
    static-joint prune ``prune_deg``, the optional drift veto, the
    coarticulation merge ``coart_merge``); ``refine="none"`` is the
    reference-parity build.

    ``tree="motion"`` (default) orders links by single-revolute
    consistency + proximity (structure.motion_tree); when it disagrees with
    the reference's proximity MST the two topologies are arbitrated by a
    short chain-fit probe.  ``tree="mst"`` forces the proximity MST.

    ``reassign`` runs the carry-test boundary-cluster reassignment,
    ``dof_guard`` the rigidity guard of an unknown-DoF pick, and
    ``dof_probe`` (with ``unknown_dof``) arbitrates the link count with the
    chain-fit probe ladder (structure.probe_k_selection).
    ``chain_anchors`` > 1 averages the chain fit over that many anchor
    steps; ``canonical_frames``, ``chain_trunc`` and ``chain_balance`` are
    the fit's opt-in options (joints.chain.refine_chain).
    """
    if refine not in ("chain", "none"):
        raise ValueError(f"unknown refine mode {refine!r}")
    t_start = time.time()
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
        probe_k_selection,
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
    refine_frames = None
    if unknown_dof and dof_probe:
        refine_frames = _load_refine_frames(cfg, end_video)
        k_before = len(groups)
        probe_groups, _ = probe_k_selection(
            sum_map, cms, refine_frames[0], k0=k_before,
            frame_masks=refine_frames[1], carry_stack=carry_stack,
            probe_steps=dof_probe_steps, points_per_link=dof_probe_points,
            share_normalize=ladder_share_norm, verbose=verbose, device=dev,
        )
        if len(probe_groups) != k_before:
            # keep the main-path partition when the probe confirms k: it
            # already carries the guard's boundary refinement
            groups = probe_groups
            dof = len(groups) - 1
            if verbose:
                print(f"[urdf] probe ladder overrode DoF pick: links={len(groups)} dof={dof}")
    if tree == "motion":
        links = motion_tree(cms, groups, num_steps)
        links_mst = kinematics_tree(cms[0], groups, cluster_mst(cms[0]))

        def _edges(ls):
            return {frozenset((l.id, l.parent_id)) for l in ls if l.parent_id is not None}

        if _edges(links_mst) != _edges(links):
            # the two topology hypotheses disagree: a composite joint
            # modelled as one revolute cannot track the clouds, so the
            # short chain fit's loss picks the true tree
            if refine_frames is None:
                refine_frames = _load_refine_frames(cfg, end_video)
            links = _select_tree_by_chain_fit(
                {"motion": links, "proximity-mst": links_mst},
                cms, refine_frames[0], refine_frames[1], num_steps, verbose, device=dev,
            )
    else:
        links = kinematics_tree(cms[0], groups, cluster_mst(cms[0]))
    # cms are already sliced to [start_steps:end_steps]; index them 0-based
    joints = estimate_joints_from_tree(links, cms, 0, num_steps, interval=4)

    if refine == "chain" and joints:
        if refine_frames is None:
            refine_frames = _load_refine_frames(cfg, end_video)
        links, joints, dof = _refine_chain_loop(
            links, joints, cms, refine_frames, num_steps, dof,
            refine_steps=refine_steps, chain_balance=chain_balance,
            canonical_frames=canonical_frames, chain_anchors=chain_anchors,
            chain_trunc=chain_trunc, freeze_prune=freeze_prune, prune_deg=prune_deg,
            drift_prune=drift_prune, drift_theta_deg=drift_theta_deg, drift_conc=drift_conc,
            drift_spread_deg=drift_spread_deg, coart_merge=coart_merge, verbose=verbose,
            device=dev)

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
    with _telemetry(cfg).stage("build_urdf", robot=cfg.robot, links=len(links), dof=dof,
                               seconds_total=round(time.time() - t_start, 3)):
        pass
    return {
        "urdf_path": urdf_path,
        "num_links": len(links),
        "dof": dof,
        "mesh_paths": mesh_paths,
        "links": links,
        "joints": joints,
    }


def run_evaluation(
    cfg: PipelineConfig,
    joint_map: np.ndarray | None = None,
    asset_root: str | None = None,
    verbose: bool = True,
    num_configs: int = 3,
    pred_ori: tuple | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Score the predicted URDF against the robot's ground truth: joint
    axis-line errors (eval.compare_joints), the re-simulation Chamfer on
    ``device`` (eval.resim_chamfer) and, for context, the same protocol's
    gt-vs-gt floor.  Writes ``cfg.eval_dir()``: pos_mean_std.txt,
    dir_mean_std.txt, coverage.txt, per_joint.txt, floor.txt and the resim
    clouds.

    ``pred_ori`` overrides the registry's predicted-URDF base euler.  The
    registry value corrects the reference's REAL scans (captured with a
    rolled base); data captured by this framework's own simulator is in
    sim_ori's frame already, so self-generated real-layout runs pass
    ``pred_ori=(0, 0, 0)``."""
    from .eval import compare_joints, load_offset, resim_chamfer

    dev = resolve_device(device)
    robot = get_robot(cfg.robot)
    offset = load_offset(cfg.raw_dir())
    if pred_ori is None:
        pred_ori = robot.ori
    cmp = compare_joints(
        pred_urdf_path=cfg.urdf_path(),
        gt_urdf_path=robot.gt_path(asset_root),
        dof=robot.dof,
        offset=offset,
        sim_ori=robot.sim_ori,
        pred_ori=pred_ori,
        joint_map=joint_map,
        global_scale=robot.global_scale,
        asset_root=asset_root,
    )
    eval_dir = cfg.eval_dir()
    os.makedirs(eval_dir, exist_ok=True)
    np.savetxt(os.path.join(eval_dir, "pos_mean_std.txt"),
               (np.mean(cmp.pos_errors), np.std(cmp.pos_errors)))
    np.savetxt(os.path.join(eval_dir, "dir_mean_std.txt"),
               (np.mean(cmp.dir_errors), np.std(cmp.dir_errors)))
    with open(os.path.join(eval_dir, "coverage.txt"), "w") as f:
        f.write(f"matched {cmp.matched} / {cmp.total}\n")
        f.write(f"dir_mean_matched {cmp.dir_mean_matched:.4f}\n")
        f.write(f"dir_mean_complete {cmp.dir_mean_complete:.4f}\n")
        f.write(f"pos_mean_complete {cmp.pos_mean_complete:.6f}\n")
    # per-joint breakdown: which gt joint maps to which predicted joint and
    # its individual errors
    with open(os.path.join(eval_dir, "per_joint.txt"), "w") as f:
        f.write("gt_joint pred_joint dir_err_deg pos_err_m\n")
        jm = cmp.joint_map if cmp.joint_map is not None else []
        dc = cmp.dir_errors_complete or []
        pc = cmp.pos_errors_complete or []
        for gi, pi in enumerate(jm):
            de = f"{dc[gi]:.3f}" if gi < len(dc) else "nan"
            pe = f"{pc[gi]:.5f}" if gi < len(pc) else "nan"
            f.write(f"{gi} {int(pi)} {de} {pe}\n")
    if verbose:
        print(f"[eval] joint pos err {np.mean(cmp.pos_errors):.4f} m, "
              f"dir err {np.mean(cmp.dir_errors):.2f} deg "
              f"(matched {cmp.matched}/{cmp.total}, "
              f"complete {cmp.dir_mean_complete:.2f} deg)")

    losses, mean, std = resim_chamfer(
        pred_urdf_path=cfg.urdf_path(),
        gt_urdf_path=robot.gt_path(asset_root),
        dof=robot.dof,
        offset=offset,
        joint_map=cmp.joint_map,
        direction_map=cmp.direction_map,
        save_path=eval_dir,
        sim_ori=robot.sim_ori,
        pred_ori=pred_ori,
        radius=robot.cam_dist,
        num_cameras=cfg.num_cameras,
        global_scale=robot.global_scale,
        asset_root=asset_root,
        seed=cfg.seed,
        num_configs=num_configs,
        device=dev,
    )
    if verbose:
        print(f"[eval] resim chamfer {mean:.4f} +- {std:.4f}")
    # metric context: the same protocol's gt-vs-gt score — capture +
    # sampling + unobservable-surface floor; a resim number is only
    # interpretable next to its floor
    gt_path = robot.gt_path(asset_root)
    rng_floor = np.random.default_rng(cfg.seed)
    _, floor_mean, _ = resim_chamfer(
        pred_urdf_path=gt_path, gt_urdf_path=gt_path, dof=robot.dof,
        offset=np.zeros(robot.dof),
        joint_map=np.arange(robot.dof), direction_map=[1.0] * robot.dof,
        sim_ori=robot.sim_ori, pred_ori=robot.sim_ori,
        radius=robot.cam_dist, num_cameras=cfg.num_cameras,
        asset_root=asset_root, seed=cfg.seed, num_configs=num_configs,
        a_list=rng_floor.random((num_configs, robot.dof)) * 2.0 - 1.0,
        device=dev,
    )
    np.savetxt(os.path.join(eval_dir, "floor.txt"), [floor_mean])
    if verbose:
        print(f"[eval] resim floor (gt-vs-gt) {floor_mean:.4f}")
    with _telemetry(cfg).stage("evaluate", robot=cfg.robot,
                               dir_mean=round(float(np.mean(cmp.dir_errors)), 3)
                               if cmp.dir_errors else None,
                               chamfer_mean=round(mean, 4)):
        pass
    return {
        "pos_errors": cmp.pos_errors,
        "dir_errors": cmp.dir_errors,
        "pos_mean": float(np.mean(cmp.pos_errors)),
        "dir_mean": float(np.mean(cmp.dir_errors)),
        "matched": cmp.matched,
        "total": cmp.total,
        "dir_mean_matched": cmp.dir_mean_matched,
        "dir_mean_complete": cmp.dir_mean_complete,
        "pos_mean_complete": cmp.pos_mean_complete,
        "chamfer_losses": losses.tolist(),
        "chamfer_mean": mean,
        "chamfer_std": std,
        "chamfer_floor": floor_mean,
    }
