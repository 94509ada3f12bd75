"""Command-line interface of the port; only ``register`` is ported so far.

    python -m autourdf_tpu_torch.cli register --robot wx200_real_5 --data-root data_real
    python -m autourdf_tpu_torch.cli register ... --device cpu   (plain PyTorch path)
"""

from __future__ import annotations

import argparse
import json

from .config import PipelineConfig, load_parameters_json


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="autourdf-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("register", help="cluster registration over all sequences")
    p.add_argument("--robot", type=str, default="wx200_5")
    p.add_argument("--data-root", type=str, default="data")
    p.add_argument("--step-size", type=int, default=4, help="motor step size (deg)")
    p.add_argument("--num-cameras", type=int, default=20)
    p.add_argument("--num-video", type=int, default=5, help="number of sequences")
    p.add_argument("--num-seg", type=int, default=None,
                   help="override the registry's cluster count K (changes the "
                        "{robot}_{K}_seg artifact paths)")
    p.add_argument("--seed-mode", type=str, default="kmeans++", choices=["kmeans++", "fps"])
    p.add_argument("--parameters-json", type=str, default=None,
                   help="overlay a reference-format parameters.json")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the segmentation (seed) and MLP init (seed + 1)")
    p.add_argument("--r", type=str, default="q", choices=["q", "rpy", "dq", "6d"])
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--mlp_icp", action="store_true",
                   help="refine each cluster with masked ICP instead of the anchor MLP")
    p.add_argument("--normal", action="store_true",
                   help="augment clustering features with point normals")
    p.add_argument("--corr-every", type=int, default=1,
                   help="refresh NN correspondences every k epochs (1 = exact "
                        "reference semantics)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])

    args = parser.parse_args(argv)
    if args.parameters_json:
        load_parameters_json(args.parameters_json)
    for flag, item in (("mlp_icp", "ops/icp.py"), ("normal", "ops/plane.py")):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} needs {item}, not ported yet "
                "(ROADMAP.md Queue 1 item 7: ICP, FPS and plane)")
    cfg = PipelineConfig(
        robot=args.robot, data_root=args.data_root, step_size_deg=args.step_size,
        num_cameras=args.num_cameras, num_videos=args.num_video, num_seg=args.num_seg,
        seed_mode=args.seed_mode, rot=args.r, epochs=args.epochs,
    )

    from . import workflow

    stats = workflow.run_registration(cfg, seed=args.seed, corr_every=args.corr_every,
                                      device=args.device)
    stats.pop("result")
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
