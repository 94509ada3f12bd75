#!/usr/bin/env python3
"""The JAX package's registration of the real scans from the port's initial
draw: the reference record that the port's same-draw checks read.

    python scripts/torch_same_draw.py record [--seed 0] [--out PATH]
    python scripts/torch_same_draw.py seeds --seeds 1 2 [--out PATH]

Both modes run the JAX package on the CPU (the platform is set in-process)
on ``data_real/raw/wx200_real_5`` (5 sequences x 10 ragged frames) at the
registration's defaults: K=20, hidden 512, mode q, 300 Adam epochs a phase.

``record`` takes the JAX package's own frame-0 segmentation at
``PRNGKey(seed)`` and the port's initial MLP weights
(``autourdf_tpu_torch.workflow._draw_weights`` at ``seed``, converted with
``params_to_jax``), registers all sequences with the JAX
``register_sequences_batched``, runs the step and anchor phases of frame
pair 0->1 once more with ``train_pose_mlp`` for their per-epoch loss
histories, and builds the JAX structure on the result (DoF search, carry
reassignment, rigidity guard).  It writes one compressed ``.npz``
(default ``tests/data/same_draw_wx200_real_5_seed<seed>.npz``) holding the
init, a checksum of the weights, the per-frame best matrices, labels and
losses, the histories and the structure.  Local points are not stored:
``local_points_from_labels`` rebuilds them from the matrices, labels and
frames.  About 25 minutes on 8 CPU cores (1,392 s for the registration).

``seeds`` runs the JAX package's own ``workflow.run_registration`` at each
seed (its own draws of segmentation and weights) into a temporary data root
and prints the JAX structure of each, one JSON line a seed.  About half an
hour a seed.

The record under ``tests/data/`` is this script's output and nothing else
writes it.  ``chip_smoke.py`` [14] and ``tests/test_torch_same_draw.py``
read it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ROBOT = "wx200_real_5"
K, HIDDEN, MODE, EPOCHS = 20, 512, "q", 300


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def weight_checksum(params: dict) -> tuple[list[str], np.ndarray, np.ndarray]:
    """``(names, sums (L,) float64, first 8 values (L, 8))`` of a port state
    dict, tensors in sorted name order."""
    names = sorted(params)
    flat = [params[n].detach().cpu().numpy().reshape(-1) for n in names]
    return (names, np.array([f.astype(np.float64).sum() for f in flat]),
            np.stack([f[:8] for f in flat]))


def jax_structure(data_root: str) -> dict:
    """The JAX package's unknown-DoF link partition before its chain fits,
    on the artifacts under ``data_root``: link counts after the DoF search,
    the carry reassignment and the rigidity guard, the final partition (a
    link index a cluster), and each link's rigidity over the guard's floor
    (``partition_rigidity`` of the link alone; 0 for a one-cluster link)."""
    from autourdf_tpu import structure, workflow
    from autourdf_tpu.config import PipelineConfig

    cfg = PipelineConfig(robot=ROBOT, data_root=data_root)
    cms, _ = workflow.build_coord_maps(cfg, None, cfg.start_steps, cfg.end_steps)
    sum_map = structure.combined_sum_map(cms, "pose")
    groups, _, _, _ = structure.auto_dof_search(sum_map)
    counts = [len(groups)]
    stack = structure.swap_consistency_stack(cms)
    groups = structure.refine_groups_by_carry(cms, groups, verbose=False, stack=stack)
    counts.append(len(groups))
    guarded, fired = structure.rigidity_guarded_groups(sum_map, stack, groups, verbose=False)
    counts.append(len(guarded))
    excess, floor = structure.carry_excess_matrix(stack)
    pre = structure.partition_rigidity(excess, groups) / max(floor, 1e-12)
    groups = sorted(sorted(int(c) for c in g) for g in guarded)
    partition = np.zeros(sum_map.shape[0], np.int64)
    for i, g in enumerate(groups):
        partition[g] = i
    rig = [structure.partition_rigidity(excess, [set(g)]) / max(floor, 1e-12) for g in groups]
    return {"counts": counts, "partition": partition.tolist(), "groups": groups,
            "link_rigidity": [float(r) for r in rig], "floor": float(floor),
            "pre_guard_rigidity": float(pre), "guard_fired": bool(fired)}


def _data_root(tmp: str) -> str:
    root = os.path.join(tmp, "data")
    os.makedirs(root)
    os.symlink(os.path.join(REPO, "data_real", "raw"), os.path.join(root, "raw"))
    return root


def record(seed: int, out: str) -> None:
    jax = _jax_cpu()
    import jax.numpy as jnp
    import torch

    from autourdf_tpu import workflow as jworkflow
    from autourdf_tpu.config import PipelineConfig
    from autourdf_tpu.models.regmlp import PoseRegressor
    from autourdf_tpu.registration import (RegistrationConfig, initial_segments,
                                           register_sequences_batched, train_pose_mlp)
    from autourdf_tpu_torch.models.regmlp import params_to_jax
    from autourdf_tpu_torch.workflow import _draw_weights, _save_registrations

    t_start = time.time()
    cfg = PipelineConfig(robot=ROBOT, data_root=os.path.join(REPO, "data_real"))
    names, frames, masks = jworkflow.load_raw_sequences_padded(cfg.raw_dir(), cfg.num_videos)
    S, T, N, _ = frames.shape
    frames_j, masks_j = jnp.asarray(frames), jnp.asarray(masks)
    init = initial_segments(jax.random.PRNGKey(seed), frames_j[0, 0], K, n_init=10,
                            mask=masks_j[0, 0])
    _, step_p, anchor_p = _draw_weights(S, seed, "cpu", MODE, HIDDEN)
    to_j = lambda p: jax.tree.map(jnp.asarray, params_to_jax(p, MODE))
    sp, ap = to_j(step_p), to_j(anchor_p)
    w_names, step_sum, step_head = weight_checksum(step_p)
    _, anchor_sum, anchor_head = weight_checksum(anchor_p)
    model = PoseRegressor(mode=MODE, hidden_dim=HIDDEN)
    reg_cfg = RegistrationConfig(num_seg=K, mode=MODE, epochs=EPOCHS)
    print(f"[record] {S} x {T} x {N} (ragged), K={K}, hidden {HIDDEN}, {EPOCHS} epochs, "
          f"seed {seed}", flush=True)

    t0 = time.time()
    res = register_sequences_batched(model, reg_cfg, sp, ap, init, frames_j, masks_j)
    res = jax.tree.map(np.asarray, res)
    reg_seconds = time.time() - t0
    print(f"[record] registration {reg_seconds:.1f} s; losses {res.losses.mean():.6f}",
          flush=True)

    # pair 0->1 again, one program a phase, for the per-epoch loss histories
    t0 = time.time()
    tile = lambda x: jnp.broadcast_to(x[None], (S,) + x.shape)
    im = tile(init.mask)

    def phase(params, m, pts, lab, lr):
        return jax.vmap(lambda p, mm, t, x, lb, tm, pm: train_pose_mlp(
            model, p, mm, t, x, lb, target_mask=tm, points_mask=pm, epochs=EPOCHS,
            learning_rate=lr))(params, m, frames_j[:, 1], pts, lab, masks_j[:, 1], im)

    step_res = phase(sp, tile(init.matrices), tile(init.points), tile(init.labels),
                     reg_cfg.lr_step)
    anchor_res = phase(ap, step_res.best_matrices, tile(init.points), tile(init.labels),
                       reg_cfg.lr_anchor)
    hist_seconds = time.time() - t0
    hist_gap = [float(np.max(np.abs(np.asarray(step_res.best_loss) - res.step_losses[:, 0]))),
                float(np.max(np.abs(np.asarray(anchor_res.best_loss) - res.losses[:, 0])))]
    print(f"[record] pair 0->1 histories {hist_seconds:.1f} s; their best losses against the "
          f"batched driver's (step, anchor): {hist_gap}", flush=True)

    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="same_draw_") as tmp:
        root = _data_root(tmp)
        from autourdf_tpu_torch.config import PipelineConfig as TConfig

        _save_registrations(TConfig(robot=ROBOT, data_root=root), names, res.matrices,
                            res.local_points, res.labels, res.losses, masks)
        struct = jax_structure(root)
    print(f"[record] structure {time.time() - t0:.1f} s: {json.dumps(struct)}", flush=True)

    labels = res.labels
    if labels.max() >= 256 or labels.min() < 0:
        raise ValueError("labels do not fit uint8")
    init_np = jax.tree.map(np.asarray, init)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(
        out,
        seed=np.int64(seed), epochs=np.int64(EPOCHS), names=np.array(names),
        n_capacity=np.int64(N),
        init_matrices=init_np.matrices, init_points=init_np.points,
        init_labels=init_np.labels.astype(np.uint8), init_mask=init_np.mask,
        weight_names=np.array(w_names), weight_sum=np.stack([step_sum, anchor_sum]),
        weight_head=np.stack([step_head, anchor_head]),
        matrices=res.matrices, labels=labels.astype(np.uint8),
        losses=res.losses, step_losses=res.step_losses,
        history_step=np.asarray(step_res.loss_history),
        history_anchor=np.asarray(anchor_res.loss_history),
        history_best_gap=np.array(hist_gap),
        structure_counts=np.array(struct["counts"]),
        structure_partition=np.array(struct["partition"]),
        structure_link_rigidity=np.array(struct["link_rigidity"]),
        structure_floor=np.float64(struct["floor"]),
        structure_pre_guard_rigidity=np.float64(struct["pre_guard_rigidity"]),
        registration_seconds=np.float64(reg_seconds),
        jax_version=np.array(jax.__version__), torch_version=np.array(torch.__version__),
    )
    print(f"[record] wrote {out} ({os.path.getsize(out)} bytes) in "
          f"{time.time() - t_start:.1f} s", flush=True)


def seeds(seed_list: list[int], out: str | None) -> None:
    _jax_cpu()
    from autourdf_tpu import workflow as jworkflow
    from autourdf_tpu.config import PipelineConfig

    rows = []
    for seed in seed_list:
        with tempfile.TemporaryDirectory(prefix="same_draw_") as tmp:
            root = _data_root(tmp)
            t0 = time.time()
            stats = jworkflow.run_registration(PipelineConfig(robot=ROBOT, data_root=root),
                                               seed=seed, verbose=False)
            reg_seconds = time.time() - t0
            struct = jax_structure(root)
        row = {"seed": seed, "registration_seconds": reg_seconds,
               "mean_loss": stats["mean_loss"], **struct}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if out:
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="mode", required=True)
    r = sub.add_parser("record", help="the same-draw reference record")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--out", default=None)
    s = sub.add_parser("seeds", help="the JAX package's own draws, structure a seed")
    s.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    s.add_argument("--out", default=None, help="also write the rows as JSON here")
    args = p.parse_args(argv)
    if args.mode == "record":
        record(args.seed, args.out or os.path.join(
            REPO, "tests", "data", f"same_draw_{ROBOT}_seed{args.seed}.npz"))
    else:
        seeds(args.seeds, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
