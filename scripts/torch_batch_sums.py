#!/usr/bin/env python3
"""What the port's batch-invariant sums (autourdf_tpu_torch/ops/reduce.py)
cost and change, measured on the card against another checkout of the repo
(for example the commit before they came in).

    python3 scripts/torch_batch_sums.py epochs [--tree DIR] [--epochs 50]
    python3 scripts/torch_batch_sums.py builds [--tree DIR] [--seeds 2024 2025 2026]

``--tree`` is the root of the checkout whose ``autourdf_tpu_torch`` is
measured (default: this one).

- ``epochs``: the wall time of one registration training epoch at the main
  path's shape (5 sequences of 4,988 points, K=20, hidden 512, mode q; the
  shape of ``chip_smoke.py`` [4b]), best of 3 runs of ``--epochs`` epochs,
  and the device kernels an epoch launches (torch.profiler).
- ``builds``: ``cli all`` at the JAX CLI's defaults on the tracked wx200
  estimate (``chip_smoke.py`` [11]) once per dataset seed, the runs side by
  side in their own processes and data roots: links, DoF, mean joint
  direction error and mean re-simulation Chamfer of each.  The results do
  not depend on the runs sharing the card; their times do, and are not
  reported.

Prints the card's name and power limit, then one JSON line.  Needs one
NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WX200_ESTIMATE = os.path.join("data_ab5", "urdf", "wx200_5_20_seg", "4_deg_20_cams.urdf")


def time_epochs(epochs: int) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from autourdf_tpu_torch.models.regmlp import PoseRegressor
    from autourdf_tpu_torch.registration.optimizer import train_epochs, train_init

    dev = torch.device("cuda", 0)
    S, K, n = 5, 20, 4988
    rng = np.random.default_rng(2)
    model = PoseRegressor("q", 512, num_seqs=S, generator=torch.Generator().manual_seed(0),
                          device=dev)
    mats = torch.eye(4, device=dev).repeat(S, K, 1, 1)
    mats[..., :3, 3] = torch.from_numpy(rng.uniform(-0.2, 0.2, (S, K, 3))).float().to(dev)
    pts = torch.from_numpy(rng.normal(scale=0.03, size=(S, n, 3))).float().to(dev)
    labels = torch.from_numpy(rng.integers(0, K, (S, n))).to(dev)
    target = torch.from_numpy(rng.uniform(-0.2, 0.2, (S, n, 3))).float().to(dev)

    def run(k):
        carry = train_init(model.flat_params(), mats, 2e-4)
        carry, losses = train_epochs(model, carry, mats, target, pts, labels, k)
        torch.cuda.synchronize(dev)
        return losses

    run(3)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses = run(epochs)
        walls.append(1e3 * (time.perf_counter() - t0) / epochs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(epochs)
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / epochs
    return {"shape": f"S={S} N={n} K={K} hidden 512", "epochs": epochs,
            "wall_ms_per_epoch": walls, "best_wall_ms_per_epoch": min(walls),
            "device_kernels_per_epoch": kernels, "last_losses": losses[:, -1].tolist()}


def run_builds(tree: str, seeds: list[int]) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=tree)
    # build the kernel and host libraries once, before the runs start
    subprocess.run([sys.executable, "-c", "from autourdf_tpu_torch.ops import _cuda; "
                    "_cuda.library('knn'); from autourdf_tpu_torch.io import native; "
                    "assert native.available()"], cwd=tree, env=env, check=True)
    with tempfile.TemporaryDirectory(prefix="batch_sums_") as tmp:
        procs = []
        for seed in seeds:
            root = os.path.join(tmp, str(seed))
            os.makedirs(root)
            params = os.path.join(root, "parameters.json")
            with open(params, "w") as f:
                json.dump({"wx200_5_ab5": {"gt": os.path.join(tree, WX200_ESTIMATE),
                                           "num_seg": 20, "dof": 5, "voxel_size": 0.003,
                                           "cam_dist": 1.5, "ori": [0, 0, 0],
                                           "sim_ori": [0, 0, 0]}}, f)
            log = open(os.path.join(root, "cli_all.log"), "w")
            procs.append((seed, root, log, subprocess.Popen(
                [sys.executable, "-m", "autourdf_tpu_torch.cli", "all", "--parameters-json",
                 params, "--robot", "wx200_5_ab5", "--data-root", root, "--seed", str(seed)],
                cwd=tree, env=env, stdout=log, stderr=subprocess.STDOUT)))
        out = []
        for seed, root, log, p in procs:
            rc = p.wait()
            log.close()
            rec = {"seed": seed, "rc": rc}
            if rc == 0:
                with open(os.path.join(root, "telemetry.json")) as f:
                    tel = {r["stage"]: r for r in json.load(f)}
                rec.update(links=tel["build_urdf"]["links"], dof=tel["build_urdf"]["dof"],
                           dir_mean=tel["evaluate"]["dir_mean"],
                           chamfer_mean=tel["evaluate"]["chamfer_mean"])
            else:
                with open(os.path.join(root, "cli_all.log")) as f:
                    rec["tail"] = f.read()[-2000:]
            out.append(rec)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["epochs", "builds"])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--seeds", type=int, nargs="+", default=[2024, 2025, 2026])
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_batch_sums: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    import autourdf_tpu_torch

    has_row_sums = os.path.exists(os.path.join(tree, "autourdf_tpu_torch", "ops", "reduce.py"))
    rec = {"what": args.what, "tree": tree, "package": os.path.dirname(autourdf_tpu_torch.__file__),
           "row_sums": has_row_sums}
    if args.what == "epochs":
        rec.update(time_epochs(args.epochs))
    else:
        rec["builds"] = run_builds(tree, args.seeds)
    print(json.dumps(rec))
    return 0 if all(b.get("rc", 0) == 0 for b in rec.get("builds", [])) else 1


if __name__ == "__main__":
    sys.exit(main())
