"""Command-line interface of the port: the ``dataset``, ``register``,
``urdf`` and ``evaluate`` stages and ``all`` of them in a row.

    python -m autourdf_tpu_torch.cli dataset --robot wx200_5
    python -m autourdf_tpu_torch.cli register --robot wx200_real_5 --data-root data_real
    python -m autourdf_tpu_torch.cli register ... --mlp_icp --normal --seed-mode fps
    python -m autourdf_tpu_torch.cli urdf --robot wx200_real_5 --data-root data_real \\
        --end-video 5 [--unknown-dof]
    python -m autourdf_tpu_torch.cli evaluate --robot wx200_5
    python -m autourdf_tpu_torch.cli all --robot wx200_5   (dataset -> register -> urdf
        -> evaluate)
    python -m autourdf_tpu_torch.cli <stage> ... --device cpu   (plain PyTorch path)

``urdf`` takes every flag of ``python -m autourdf_tpu.cli urdf`` with its
defaults: the kinematic-chain fit (``--refine chain``), the motion tree
arbitrated against the proximity MST (``--tree motion``) and, with
``--unknown-dof``, the DoF probe ladder; ``--refine none --tree mst
--no-dof-probe`` is the reference-parity build.

Seeds are the JAX CLI's: ``--seed`` (default 2024) seeds the simulated
dataset and the evaluation; ``register`` takes its own ``--seed`` (default
0, the segmentation and the MLP init), and ``all`` registers at seed 0 and
builds the URDF with the unknown DoF.  Unlike the JAX CLI, ``--pix`` is
honoured (the JAX CLI accepts it and captures at 800 whatever it says).
"""

from __future__ import annotations

import argparse
import json

from .config import PipelineConfig, load_parameters_json


def _add_common(p: argparse.ArgumentParser, seed_default: int, seed_help: str) -> None:
    p.add_argument("--robot", type=str, default="wx200_5")
    p.add_argument("--data-root", type=str, default="data")
    p.add_argument("--step-size", type=int, default=4, help="motor step size (deg)")
    p.add_argument("--num-cameras", type=int, default=20)
    p.add_argument("--num-step", type=int, default=10, help="frames per sequence")
    p.add_argument("--num-video", type=int, default=5, help="number of sequences")
    p.add_argument("--num-points", type=int, default=5000)
    p.add_argument("--voxel-size", type=float, default=None,
                   help="override the registry's mesh voxel size (m)")
    p.add_argument("--num-seg", type=int, default=None,
                   help="override the registry's cluster count K (changes the "
                        "{robot}_{K}_seg artifact paths, so pass it to every stage)")
    p.add_argument("--seed-mode", type=str, default="kmeans++", choices=["kmeans++", "fps"],
                   help="frame-0 cluster seeding: kmeans++ = reference parity "
                        "(density-proportional); fps = farthest-point (density-"
                        "independent, guarantees small links get clusters)")
    p.add_argument("--parameters-json", type=str, default=None,
                   help="overlay a reference-format parameters.json")
    p.add_argument("--asset-root", type=str, default=None)
    p.add_argument("--seed", type=int, default=seed_default, help=seed_help)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])


def _cfg(args) -> PipelineConfig:
    if args.parameters_json:
        load_parameters_json(args.parameters_json)
    return PipelineConfig(
        robot=args.robot, data_root=args.data_root, step_size_deg=args.step_size,
        num_cameras=args.num_cameras, num_step=args.num_step, num_videos=args.num_video,
        num_points=args.num_points, num_seg=args.num_seg, seed_mode=args.seed_mode,
        voxel_size=args.voxel_size, seed=args.seed, rot=getattr(args, "r", "q"),
        epochs=getattr(args, "epochs", 300),
        end_steps=getattr(args, "end_steps", args.num_step),
        noise=not getattr(args, "no_noise", False), pix=getattr(args, "pix", 800),
    )


def _add_urdf_flags(p: argparse.ArgumentParser) -> None:
    """Structure-discovery / chain-refinement flags of the ``urdf`` stage,
    with the JAX CLI's names and defaults."""
    p.add_argument("--dist-mode", type=str, default="pose",
                   choices=["pose", "diff", "legacy", "rigid", "swap", "hybrid"],
                   help="pose/diff/legacy = reference maps; rigid = relative-pose "
                        "deviation; swap = observation-level swap-consistency; "
                        "hybrid = mean of pose and swap")
    p.add_argument("--dof-method", type=str, default="auto",
                   choices=["auto", "gap", "silhouette"],
                   help="auto = gap when decisive else silhouette; silhouette = "
                        "reference parity")
    p.add_argument("--refine", type=str, default="chain", choices=["chain", "none"],
                   help="chain = global kinematic-chain joint refinement; none = "
                        "reference parity")
    p.add_argument("--refine-steps", type=int, default=1200, help="chain fit: Adam steps")
    p.add_argument("--canonical-frames", type=int, default=1,
                   help="chain fit: registered steps per canonical link cloud")
    p.add_argument("--chain-anchors", type=int, default=1,
                   help="chain fit: canonical anchor steps to average over")
    p.add_argument("--chain-trunc", type=float, default=0.0,
                   help="chain fit: truncated robust Chamfer multiple (0 disables)")
    p.add_argument("--chain-balance", action="store_true",
                   help="chain fit: per-link balanced forward Chamfer")
    p.add_argument("--tree", type=str, default="motion", choices=["motion", "mst"],
                   help="link tree: motion = revolute-consistency MST, arbitrated by a "
                        "short chain fit where it disagrees with the proximity MST; "
                        "mst = reference proximity MST")
    p.add_argument("--no-reassign", action="store_true",
                   help="skip the carry-test boundary-cluster reassignment")
    p.add_argument("--no-dof-guard", action="store_true",
                   help="skip the observation-level rigidity guard that escalates "
                        "under-split unknown-DoF picks")
    p.add_argument("--no-dof-probe", action="store_true",
                   help="skip the chain-fit probe ladder that arbitrates the "
                        "unknown-DoF link count")
    p.add_argument("--ladder-share-norm", action=argparse.BooleanOptionalAction, default=True,
                   help="probe ladder: judge each drop against the changed region's "
                        "point share")
    p.add_argument("--prune-deg", type=float, default=2.0,
                   help="chain fit: merge joints whose fitted range stays below this")
    p.add_argument("--drift-prune", action="store_true",
                   help="chain fit: also merge weakly excited, axis-incoherent joints")
    p.add_argument("--drift-theta-deg", type=float, default=12.0)
    p.add_argument("--drift-conc", type=float, default=0.85)
    p.add_argument("--drift-spread-deg", type=float, default=45.0)
    p.add_argument("--freeze-prune", type=float, default=0.25,
                   help="chain fit: freeze-delta veto threshold (0 disables)")
    p.add_argument("--coart-merge", action=argparse.BooleanOptionalAction, default=True,
                   help="chain fit: merge sibling links that track one physical hinge")


def _urdf_kwargs(args) -> dict:
    return dict(
        dist_mode=args.dist_mode, dof_method=args.dof_method,
        refine=args.refine, refine_steps=args.refine_steps, tree=args.tree,
        chain_balance=args.chain_balance, chain_anchors=args.chain_anchors,
        canonical_frames=args.canonical_frames, chain_trunc=args.chain_trunc,
        reassign=not args.no_reassign, dof_guard=not args.no_dof_guard,
        dof_probe=not args.no_dof_probe, ladder_share_norm=args.ladder_share_norm,
        prune_deg=args.prune_deg, drift_prune=args.drift_prune,
        freeze_prune=args.freeze_prune, drift_theta_deg=args.drift_theta_deg,
        drift_conc=args.drift_conc, drift_spread_deg=args.drift_spread_deg,
        coart_merge=args.coart_merge,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="autourdf-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("dataset", help="generate multi-view point cloud sequences")
    _add_common(p, 2024, "seed of numpy's stream (camera rigs) and of the trajectories "
                         "and capture noise")
    p.add_argument("--ground", action="store_true")
    p.add_argument("--no_noise", action="store_true")
    p.add_argument("--epoch", type=int, default=5, help="collision-free sequences")
    p.add_argument("--pix", type=int, default=800)

    p = sub.add_parser("register", help="cluster registration over all sequences")
    _add_common(p, 0, "seed of the segmentation (seed) and MLP init (seed + 1)")
    p.add_argument("--r", type=str, default="q", choices=["q", "rpy", "dq", "6d"])
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--mlp_icp", action="store_true",
                   help="refine each cluster with masked ICP instead of the anchor MLP")
    p.add_argument("--normal", action="store_true",
                   help="augment clustering features with point normals")
    p.add_argument("--corr-every", type=int, default=1,
                   help="refresh NN correspondences every k epochs (1 = exact "
                        "reference semantics)")

    p = sub.add_parser("urdf", help="structure discovery -> URDF")
    _add_common(p, 2024, "accepted for parity with the JAX CLI; the stage draws nothing")
    p.add_argument("--unknown-dof", "--unknown_dof", action="store_true", dest="unknown_dof")
    p.add_argument("--start-steps", type=int, default=0)
    p.add_argument("--end-steps", dest="end_steps", type=int, default=10)
    p.add_argument("--end-video", "--end_video", dest="end_video", type=int, default=1)
    _add_urdf_flags(p)

    p = sub.add_parser("evaluate", help="joint accuracy + resim chamfer vs gt")
    _add_common(p, 2024, "seed of the re-simulation's commands and camera rigs")
    p.add_argument("--joint-map", type=str, default=None,
                   help="path to a reference-format joint index map txt")
    p.add_argument("--num-configs", type=int, default=3)
    p.add_argument("--pred-ori", type=str, default=None,
                   help="override predicted-URDF base euler 'r,p,y' (the registry value "
                        "corrects the reference's rolled real scans; pass 0,0,0 for "
                        "self-captured real-layout data)")

    p = sub.add_parser("all", help="dataset -> register -> urdf -> evaluate")
    _add_common(p, 2024, "seed of the dataset and the evaluation (registration: seed 0)")
    p.add_argument("--r", type=str, default="q", choices=["q", "rpy", "dq", "6d"])
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--end-video", dest="end_video", type=int, default=5)
    p.add_argument("--epoch", type=int, default=5)
    p.add_argument("--pix", type=int, default=800)
    p.add_argument("--ground", action="store_true")
    p.add_argument("--no_noise", action="store_true")
    _add_urdf_flags(p)

    args = parser.parse_args(argv)
    cfg = _cfg(args)

    from . import workflow

    if args.cmd == "dataset":
        dirs = workflow.run_dataset(cfg, asset_root=args.asset_root, ground=args.ground,
                                    epochs=args.epoch, device=args.device)
        print(json.dumps({"sequences": dirs}))
    elif args.cmd == "register":
        stats = workflow.run_registration(cfg, seed=args.seed, mlp_icp=args.mlp_icp,
                                          use_normals=args.normal,
                                          corr_every=args.corr_every, device=args.device)
        stats.pop("result")
        print(json.dumps(stats))
    elif args.cmd == "urdf":
        cfg = cfg.replace(start_steps=args.start_steps, end_steps=args.end_steps)
        out = workflow.run_build_urdf(cfg, unknown_dof=args.unknown_dof,
                                      end_video=args.end_video, device=args.device,
                                      **_urdf_kwargs(args))
        print(json.dumps({"urdf": out["urdf_path"], "links": out["num_links"],
                          "dof": out["dof"]}))
    elif args.cmd == "evaluate":
        import numpy as np

        jm = np.loadtxt(args.joint_map, dtype=int) if args.joint_map else None
        po = (tuple(float(v) for v in args.pred_ori.split(","))
              if args.pred_ori else None)
        out = workflow.run_evaluation(cfg, joint_map=jm, asset_root=args.asset_root,
                                      num_configs=args.num_configs, pred_ori=po,
                                      device=args.device)
        print(json.dumps(out))
    else:
        workflow.run_dataset(cfg, asset_root=args.asset_root, ground=args.ground,
                             epochs=args.epoch, device=args.device)
        stats = workflow.run_registration(cfg, seed=0, device=args.device)
        stats.pop("result")
        out = workflow.run_build_urdf(cfg, unknown_dof=True, end_video=args.end_video,
                                      device=args.device, **_urdf_kwargs(args))
        ev = workflow.run_evaluation(cfg, asset_root=args.asset_root, device=args.device)
        print(json.dumps({"urdf": out["urdf_path"], "dof": out["dof"],
                          "links": out["num_links"],
                          "dir_err_deg": ev["dir_mean"],
                          "pos_err_m": ev["pos_mean"],
                          "matched": ev.get("matched"),
                          "total": ev.get("total"),
                          "dir_mean_complete": ev.get("dir_mean_complete"),
                          "chamfer": ev["chamfer_mean"],
                          "chamfer_floor": ev["chamfer_floor"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
