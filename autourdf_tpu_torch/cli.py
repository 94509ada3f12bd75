"""Command-line interface of the port: the ``register`` and ``urdf`` stages.

    python -m autourdf_tpu_torch.cli register --robot wx200_real_5 --data-root data_real
    python -m autourdf_tpu_torch.cli register ... --mlp_icp --normal --seed-mode fps
    python -m autourdf_tpu_torch.cli urdf --robot wx200_real_5 --data-root data_real \\
        --end-video 5 --refine none --tree mst [--unknown-dof --no-dof-probe]
    python -m autourdf_tpu_torch.cli <stage> ... --device cpu   (plain PyTorch path)

``urdf`` takes every flag of ``python -m autourdf_tpu.cli urdf``; the ones
that need the kinematic-chain fit (``--refine chain``, which is the default,
and the DoF probe ladder of ``--unknown-dof`` without ``--no-dof-probe``)
raise ``NotImplementedError`` until that slice is ported.
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
        voxel_size=args.voxel_size, rot=getattr(args, "r", "q"),
        epochs=getattr(args, "epochs", 300),
        end_steps=getattr(args, "end_steps", args.num_step),
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
                   help="chain = global kinematic-chain joint refinement (not ported "
                        "yet: raises); none = reference parity")
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
                   help="link tree: motion = revolute-consistency MST (raises when it "
                        "disagrees with the proximity MST: the arbitration needs the "
                        "chain fit); mst = reference proximity MST")
    p.add_argument("--no-reassign", action="store_true",
                   help="skip the carry-test boundary-cluster reassignment")
    p.add_argument("--no-dof-guard", action="store_true",
                   help="skip the observation-level rigidity guard that escalates "
                        "under-split unknown-DoF picks")
    p.add_argument("--no-dof-probe", action="store_true",
                   help="skip the chain-fit probe ladder that arbitrates the "
                        "unknown-DoF link count (the ladder is not ported yet)")
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

    args = parser.parse_args(argv)
    cfg = _cfg(args)

    from . import workflow

    if args.cmd == "register":
        stats = workflow.run_registration(cfg, seed=args.seed, mlp_icp=args.mlp_icp,
                                          use_normals=args.normal,
                                          corr_every=args.corr_every, device=args.device)
        stats.pop("result")
        print(json.dumps(stats))
    else:
        cfg = cfg.replace(start_steps=args.start_steps, end_steps=args.end_steps)
        out = workflow.run_build_urdf(cfg, unknown_dof=args.unknown_dof,
                                      end_video=args.end_video, device=args.device,
                                      **_urdf_kwargs(args))
        print(json.dumps({"urdf": out["urdf_path"], "links": out["num_links"],
                          "dof": out["dof"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
