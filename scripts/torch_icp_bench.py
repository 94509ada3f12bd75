#!/usr/bin/env python3
"""The port's ICP (autourdf_tpu_torch/ops/icp.py) and normals
(autourdf_tpu_torch/ops/plane.py) timed on the card at the shapes of their
call sites, against another checkout of the repo (for example the commit
before a redesign).

    python3 scripts/torch_icp_bench.py [--tree DIR] [--reps 10]

``--tree`` is the root of the checkout whose ``autourdf_tpu_torch`` is
measured (default: this one).  The ICPs run on seeded synthetic clouds at the
shapes of ``chip_smoke.py`` [15]'s sites and of ``--mlp_icp``: a link ICP (6
links x 2,250 masked points, 50 iterations), the chain fit's polish (2 x
1,024 against one masked target, 30), the evaluation's resim alignment (one
10,000-point pair, 50) and the registration's per-cluster ICP (100 clusters x
4,988 points, 5% of them selected, 30).  For each: the eager loop's wall ms,
the program's first call (capture included) and its replay (wall ms, median
of ``--reps``; device ms by torch.profiler), the graph's nodes, the launches
a call and the transforms' sum, a checksum that two checkouts share to the
fp32 round-off of their steps.  The normals: ``estimate_normals`` of a
4,988-point sheet (k = 30) eagerly and as a program (nodes, replay ms).

``--designs`` also builds ``scripts/pca_normals_designs.cu`` (designs of
the normals' kernel, none of them on a path of the port) with the port's
nvcc flags and times each design and the port's ``pca_normals_kernel`` on
the same neighbourhoods (4,988 and 20,000 points of a bumpy sheet, k = 30;
device ms by torch.profiler, each held to the plain version as
``chip_smoke.py`` [3] holds the kernel).

Prints the card's name and power limit, then one JSON line.  Needs one
NVIDIA GPU; run two checkouts in one call, in turns, to compare them.
This script is temporary: the port's benchmark is to take over its
measurements.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (B, N, M, iterations, threshold, source mask density, target mask
# density, one target for the batch)
SITES = {"link": (6, 2250, 2250, 50, 0.02, 0.9, 0.9, False),
         "polish": (2, 1024, 1024, 30, 0.01, 0.95, 0.95, True),
         "resim": (1, 10000, 10000, 50, 0.05, None, None, False),
         "mlp_icp": (100, 4988, 4988, 30, 0.02, 0.05, 0.5, False)}
NORMALS_N, NORMALS_K = 4988, 30
# scripts/pca_normals_designs.cu pca_design_launch's designs, in its order;
# the cloud design holds at most about 18,000 points in shared memory
DESIGNS = ("thread", "lanes<1>", "lanes<4>", "lanes<8>", "lanes<16>", "lanes<8> solver",
           "lanes<8> cloud")
DESIGN_SIZES = (4988, 20000)


def _wall_ms(fn, reps: int) -> float:
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
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


def _site_inputs(dev, B, N, M, src_density, tgt_density, shared, seed=0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    src = rng.normal(scale=[0.12, 0.08, 0.05], size=(B, N, 3)) + rng.normal(0, 0.3, (B, 1, 3))
    angle = rng.normal(0, 0.03, B)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.zeros((B, 3, 3))
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1], rot[:, 2, 2] = c, -s, s, c, 1.0
    tgt = np.einsum("bij,bnj->bni", rot, src[:, :M]) + rng.normal(0, 2e-3, (B, M, 3))
    if shared:
        tgt = np.broadcast_to(tgt[:1], tgt.shape)
    sm = None if src_density is None else rng.random((B, N)) < src_density
    tm = None if tgt_density is None else rng.random((B, M)) < tgt_density
    if shared and tm is not None:
        tm = np.broadcast_to(tm[:1], tm.shape)
    return tuple(None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (src.astype(np.float32), tgt.astype(np.float32), sm, tm))


def _sheet(n: int, seed: int):
    """``n`` points of a bumpy sheet 0.6 wide, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.3, 0.3, (n, 2))
    pts = np.c_[xy, 0.03 * np.sin(9 * xy[:, 0]) + rng.normal(0, 1e-3, n)]
    return torch.from_numpy(pts.astype(np.float32)).cuda()


def _designs_library():
    """``scripts/pca_normals_designs.cu`` built with the port's flags into
    the port's build directory (keyed by the sources' hash)."""
    import ctypes
    import hashlib

    from autourdf_tpu_torch.ops import _cuda

    src = os.path.join(REPO, "scripts", "pca_normals_designs.cu")
    digest = hashlib.sha256()
    for path in (src, os.path.join(_cuda.CSRC, "geom.cu")):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(_cuda.NVCC_FLAGS).encode())
    so = os.path.join(_cuda.BUILD_DIR, f"libpca_designs_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
        res = subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", so, src],
                             capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pca_design_launch.argtypes = [I, P, P, I, I, P, P]
    lib.pca_design_launch.restype = I
    return lib


def measure_designs(reps: int) -> dict:
    """Each design of ``scripts/pca_normals_designs.cu`` and the port's
    kernel on the same inputs: device ms (torch.profiler, the kernel alone),
    wall ms of a launch, 1 - min |dot| against the plain version where the
    two smallest eigenvalues are 10% apart (tolerance 1e-4), the largest
    |norm - 1| (1e-6), n_z >= 0, and whether the normals equal the port's
    bit for bit."""
    import torch

    from autourdf_tpu_torch.ops import _cuda, plane

    lib = _designs_library()
    rec: dict = {}
    for n in DESIGN_SIZES:
        pts = _sheet(n, seed=n)
        idx = plane.neighbour_indices(pts, NORMALS_K)
        ref = plane._pca_normals_plain(pts, idx)
        nb = pts.double()[idx]
        c = nb - nb.mean(1, keepdim=True)
        e = torch.linalg.eigvalsh(torch.einsum("nki,nkj->nij", c, c))
        gap = e[:, 1] - e[:, 0]
        sep = (gap > 0.1 * e[:, 1]) & (gap > 1e-4 * e[:, 2])
        port = plane.pca_normals(pts, idx)

        def held(v):
            worst = float(1 - (v * ref).sum(1).abs()[sep].min())
            unit = float((v.norm(dim=1) - 1).abs().max())
            return worst, unit, bool((v[:, 2] >= 0).all())

        worst, unit, up = held(port)
        rows = {"port pca_normals_kernel": {
            "device_ms": _device_ms(lambda: plane.pca_normals(pts, idx), reps),
            "wall_ms": _wall_ms(lambda: plane.pca_normals(pts, idx), reps),
            "one_minus_dot": worst, "norm_err": unit, "up": up, "equal_to_port": True}}
        for d, name in enumerate(DESIGNS):
            if name.endswith("cloud") and n > 18000:
                continue
            out = torch.empty_like(pts)

            def launch(d=d, out=out):
                _cuda.check(lib.pca_design_launch(d, pts.data_ptr(), idx.data_ptr(), n,
                                                  NORMALS_K, out.data_ptr(), _cuda.stream(pts)),
                            f"pca design {name}")
            launch()
            torch.cuda.synchronize()
            worst, unit, up = held(out)
            rows[name] = {"device_ms": _device_ms(launch, reps), "wall_ms": _wall_ms(launch, reps),
                          "one_minus_dot": worst, "norm_err": unit, "up": up,
                          "equal_to_port": bool(torch.equal(out, port))}
        for name, r in rows.items():
            ok = r["one_minus_dot"] < 1e-4 and r["norm_err"] <= 1e-6 and r["up"]
            r["held"] = ok
            print(f"  normals design {name:24s} N={n}: device {r['device_ms']:.5f} ms, wall "
                  f"{r['wall_ms']:.5f} ms; 1 - min |dot| {r['one_minus_dot']:.3g}, |norm - 1| "
                  f"{r['norm_err']:.3g}, n_z >= 0 {r['up']}, equal to the port's "
                  f"{r['equal_to_port']}; held {ok}", flush=True)
        rec[f"N={n} k={NORMALS_K}"] = {"separated": int(sep.sum()), "designs": rows}
    return rec


def measure(reps: int, dev) -> dict:
    import torch

    from autourdf_tpu_torch.ops import _cuda
    from autourdf_tpu_torch.ops.icp import icp_point_to_point
    from autourdf_tpu_torch.ops.plane import estimate_normals
    from autourdf_tpu_torch.utils import programs

    rec: dict = {}
    for site, (B, N, M, iters, threshold, sd, td, shared) in SITES.items():
        src, tgt, sm, tm = _site_inputs(dev, B, N, M, sd, td, shared)

        def run(eager):
            return icp_point_to_point(src, tgt, max_iterations=iters, threshold=threshold,
                                      source_mask=sm, target_mask=tm, eager=eager)

        eager_ms = _wall_ms(lambda: run(True), 3)
        programs.clear()
        made = len(programs.captures)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(False)
        torch.cuda.synchronize()
        capture_ms = 1e3 * (time.perf_counter() - t0)
        cap = programs.captures[made] if len(programs.captures) > made else {}
        before = dict(_cuda.launch_counts)
        out = run(False)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _cuda.launch_counts.items() if v != before[k]}
        replay_ms = _wall_ms(lambda: run(False), reps)
        rec[site] = {"shape": [B, N, M], "iterations": iters, "eager_ms": eager_ms,
                     "program_first_ms": capture_ms, "replay_ms": replay_ms,
                     "replay_device_ms": _device_ms(lambda: run(False)),
                     "replay_us_an_iteration": 1e3 * replay_ms / iters,
                     "nodes": cap.get("nodes"), "pool_mib": cap.get("pool_bytes", 0) / 2**20,
                     "launches": launched, "T_sum": float(out.transform.double().sum()),
                     "fitness_mean": float(out.fitness.double().mean())}
    pts = _sheet(NORMALS_N, seed=1)
    programs.clear()
    made = len(programs.captures)

    def prog():
        return programs.run(("bench_normals",), lambda p: estimate_normals(p, k=NORMALS_K), pts)

    first = prog().clone()
    cap = programs.captures[made] if len(programs.captures) > made else {}
    rec["normals"] = {"points": NORMALS_N, "k": NORMALS_K,
                      "eager_ms": _wall_ms(lambda: estimate_normals(pts, k=NORMALS_K), reps),
                      "eager_device_ms": _device_ms(lambda: estimate_normals(pts, k=NORMALS_K)),
                      "replay_ms": _wall_ms(prog, reps), "nodes": cap.get("nodes"),
                      "pool_mib": cap.get("pool_bytes", 0) / 2**20,
                      "abs_z_sum": float(first[:, 2].double().abs().sum())}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--designs", action="store_true",
                    help="also time the designs of scripts/pca_normals_designs.cu (this "
                         "checkout's port only)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_icp_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    import autourdf_tpu_torch

    rec = {"tree": tree, "package": os.path.dirname(autourdf_tpu_torch.__file__),
           "device": torch.cuda.get_device_name(0)}
    rec.update(measure(args.reps, torch.device("cuda", 0)))
    if args.designs:
        if tree != REPO:
            print("torch_icp_bench: --designs measures this checkout's port only",
                  file=sys.stderr)
            return 1
        rec["normals_designs"] = measure_designs(args.reps)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
