#!/usr/bin/env python3
"""The port's farthest-point pick (``fps_kernel``, autourdf_tpu_torch/ops/fps.py)
timed on the card at the closed loop's capture shapes, against another
checkout of the repo (for example the commit before a redesign).

    python3 scripts/torch_fps_bench.py [--tree DIR] [--reps 10]

``--tree`` is the root of the checkout whose ``autourdf_tpu_torch`` is
measured (default: this one); the robot comes from this checkout.  The
shapes are ``chip_smoke.py`` [11]'s: the tracked wx200 estimate, 200,000
surface points, 20 cameras, the dataset's capture (800 px, 5,000 picks under
the visibility mask) and the evaluation's (400 px, 10,000 picks).  For each:
the pick's wrapper ms (CUDA events, median of ``--reps``), its device ms
(torch.profiler), a whole capture's wall ms (median of 3) and a checksum of
the picks, which two checkouts with the same picks share.  Where the
checkout has the cluster design, also its set-up and, in the kernel's launch
shape, the device ms of k empty cluster barriers.

Prints the card's name and power limit, then one JSON line.  Needs one
NVIDIA GPU; run two checkouts in one call, in turns, to compare them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WX200_ESTIMATE = os.path.join("data_ab5", "urdf", "wx200_5_20_seg", "4_deg_20_cams.urdf")
# (pixels, picks, pose noise, point noise) of the dataset's and the
# evaluation's captures (chip_smoke.py time_capture)
SHAPES = ((800, 5000, 0.01, 0.0005), (400, 10000, 0.0, 0.0))


def _event_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, reps: int = 3) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def _wall_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def measure(reps: int) -> dict:
    import numpy as np
    import torch

    from autourdf_tpu_torch.ops import _cuda, fps
    from autourdf_tpu_torch.sim import KinematicEnv
    from autourdf_tpu_torch.sim.capture import visible_mask

    dev = torch.device("cuda", 0)
    env = KinematicEnv.create(os.path.join(REPO, WX200_ESTIMATE), dof=5, radius=1.5,
                              num_cameras=20, camera_rng=np.random.default_rng(0), device=dev)
    env.set_joint_positions(np.array([0.3, -0.2, 0.4, 0.1, -0.3]))
    pts = torch.from_numpy(env.posed_surface_points()).to(dev)
    rec: dict = {"cluster": hasattr(fps, "cluster_setup")}
    if rec["cluster"]:
        rec["setup"] = fps.cluster_setup(dev)._asdict()
    for pix, k, pose_noise, point_noise in SHAPES:
        vis = visible_mask(pts, env.rig, pix, pix).any(0)
        picks = fps.farthest_point_sample(pts, k, vis)
        gen = torch.Generator(device=dev).manual_seed(0)
        row = {"points": int(pts.shape[0]), "valid": int(vis.sum()), "k": k,
               "picks_sha256": hashlib.sha256(picks.cpu().numpy().tobytes()).hexdigest()[:16],
               "ms": _event_ms(lambda: fps.farthest_point_sample(pts, k, vis), reps),
               "device_ms": _device_ms(lambda: fps.farthest_point_sample(pts, k, vis)),
               "capture_wall_ms": _wall_ms(lambda: env.capture(
                   gen, num_points=k, width=pix, height=pix, pose_noise=pose_noise,
                   point_noise=point_noise))}
        if rec["cluster"]:
            lib = _cuda.library("geom")
            row["barriers_ms"] = _event_ms(lambda: _cuda.check(
                lib.geom_cluster_barriers_launch(k, _cuda.stream(pts)), "barriers"), reps)
        rec[f"{pix}px"] = row
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_fps_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    import autourdf_tpu_torch

    rec = {"tree": tree, "package": os.path.dirname(autourdf_tpu_torch.__file__),
           "device": torch.cuda.get_device_name(0)}
    rec.update(measure(args.reps))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
