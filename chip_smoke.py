#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (autourdf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on error:

1. print the device and ``nvidia-smi``'s name and power limit;
2. build the CUDA kernels from ``autourdf_tpu_torch/csrc`` (nvcc, sm_90a);
3. hold every kernel against its plain PyTorch version on the card (exact
   distances and indices) at the production shape with masked rows and
   forced ties, at a ragged shape and at the main path's shape; check the
   Chamfer value and gradients against the plain path on the CPU; time the
   kernel, the plain version and one library call, beside the bound;
4. the main path: register ``data_real/raw/wx200_real_5`` (5 sequences x 10
   ragged frames, K=20, hidden 512, mode q, 300 epochs) through
   ``workflow.run_registration`` into a temporary data root, check the
   artifacts, the losses and the kernels' launch counts;
5. print the kernel JSON line, then the result line.

Exits non-zero, printing no result, without a CUDA device or without the
repository around it.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# per (x, y) pair: 3 subtracts, 3 absolute values, 2 adds, 1 compare
OPS_PER_PAIR = 9
# Chamfer value and gradient, kernel path on the card vs the plain path on
# the CPU: the same matched neighbours (exact indices), but sums in another
# order (and index_add_ atomics on the card) move the last bits.
CHAMFER_RTOL, GRAD_ATOL = 1e-5, 1e-7
EPOCHS, PAIRS = 300, 9


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median of ``reps`` CUDA-event-timed calls after ``warm`` warm-up calls."""
    for _ in range(warm):
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


def _bound_ms(S: int, N: int, M: int, out_bytes_per_point: int) -> tuple[float, str]:
    ops = S * N * M * OPS_PER_PAIR
    nbytes = S * (N + M) * 3 * 4 + S * (N + M) * out_bytes_per_point
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _case(rng, S, N, M, dev, masked_ties: bool):
    """Clouds in a 0.6 m box.  With ``masked_ties``: trailing rows moved to
    the PAD_COORD sentinel (as masked points are), duplicated points in x
    and in y (forced ties in both directions) and points shared by x and y
    (zero distances)."""
    from autourdf_tpu_torch.ops.knn import PAD_COORD

    x = rng.uniform(-0.3, 0.3, (S, N, 3)).astype(np.float32)
    y = rng.uniform(-0.3, 0.3, (S, M, 3)).astype(np.float32)
    if masked_ties:
        y[:, 2500:2600] = y[:, 100:200]
        x[:, 3000:3100] = x[:, 10:110]
        x[:, 4000:4050] = y[:, 300:350]
        x[:, N - 300:] = PAD_COORD
        y[:, M - 200:] = PAD_COORD
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def check_kernels(dev, n_main: int) -> dict:
    """Phase 3; returns the per-kernel measurements at the main path's shape."""
    from autourdf_tpu_torch.ops import knn
    from autourdf_tpu_torch.ops.chamfer import chamfer_distance

    rng = np.random.default_rng(0)
    cases = [("production", 5, 5000, 5000, True), ("ragged", 5, 4418, 4985, False),
             ("main-path", 5, n_main, n_main, True)]
    out = {}
    for label, S, N, M, ties in cases:
        x, y = _case(rng, S, N, M, dev, ties)
        for norm in (1, 2):
            got = knn.nn_search_bidirectional(x, y, norm)
            ref = knn._nn_bidir_plain(x, y, norm)
            errs = [_max_abs(got[0], ref[0]), _max_abs(got[2], ref[2])]
            same_idx = bool(torch.equal(got[1], ref[1]) and torch.equal(got[3], ref[3]))
            print(f"  nn_bidir     {label:10s} S={S} N={N} M={M} norm={norm}: "
                  f"max|d-plain| {max(errs)}, indices equal {same_idx}")
            if max(errs) != 0.0 or not same_idx:
                _fail(f"nn_bidir disagrees with its plain version ({label}, norm {norm})")
            gmin = knn.nn_min_bidirectional(x, y, norm)
            rmin = knn._nn_min_bidir_plain(x, y, norm)
            err_min = max(_max_abs(gmin[0], rmin[0]), _max_abs(gmin[1], rmin[1]))
            print(f"  nn_min_bidir {label:10s} S={S} N={N} M={M} norm={norm}: "
                  f"max|d-plain| {err_min}")
            if err_min != 0.0:
                _fail(f"nn_min_bidir disagrees with its plain version ({label}, norm {norm})")
            out.setdefault(label, {})[norm] = {"bidir": max(errs), "min": err_min}

        # Chamfer through autograd (indexed kernel + index_add_ backward) and
        # forward-only (min-only kernel), against the plain path on the CPU
        xm = torch.ones(S, N, device=dev)
        ym = torch.ones(S, M, device=dev)
        if ties:
            xm[:, N - 300:] = 0
            ym[:, M - 200:] = 0
        vals, grads = [], []
        for d in (dev, torch.device("cpu")):
            xr = x.to(d).requires_grad_(True)
            yr = y.to(d).requires_grad_(True)
            loss = chamfer_distance(xr, yr, xm.to(d), ym.to(d))
            gx, gy = torch.autograd.grad(loss.sum(), (xr, yr))
            with torch.no_grad():
                fwd = chamfer_distance(x.to(d), y.to(d), xm.to(d), ym.to(d))
            vals.append((loss.detach().cpu(), fwd.cpu()))
            grads.append((gx.cpu(), gy.cpu()))
        val_err = max(float(((vals[0][i] - vals[1][i]).abs() / vals[1][i].abs()).max())
                      for i in (0, 1))
        grad_err = max(_max_abs(grads[0][i], grads[1][i]) for i in (0, 1))
        print(f"  chamfer      {label:10s}: value rel err {val_err:.3g} (tol {CHAMFER_RTOL}), "
              f"grad max abs err {grad_err:.3g} (tol {GRAD_ATOL})")
        if not val_err <= CHAMFER_RTOL or not grad_err <= GRAD_ATOL:
            _fail(f"chamfer_distance on the card disagrees with the plain path ({label})")

    # times at the main path's shape, norm 1 (the Chamfer-L1 loss)
    x, y = _case(np.random.default_rng(1), 5, n_main, n_main, dev, True)
    S, N, M = x.shape[0], x.shape[1], y.shape[1]

    def lib_bidir():
        d = torch.cdist(x, y, p=1)
        return d.min(-1), d.min(-2)

    def lib_min():
        d = torch.cdist(x, y, p=1)
        return d.amin(-1), d.amin(-2)

    timing = {
        "nn_bidir": dict(
            ms=_time_ms(lambda: knn.nn_search_bidirectional(x, y, 1)),
            plain_ms=_time_ms(lambda: knn._nn_bidir_plain(x, y, 1), reps=5),
            library_ms=_time_ms(lib_bidir, reps=5),
            bound=_bound_ms(S, N, M, 4 + 8)),
        "nn_min_bidir": dict(
            ms=_time_ms(lambda: knn.nn_min_bidirectional(x, y, 1)),
            plain_ms=_time_ms(lambda: knn._nn_min_bidir_plain(x, y, 1), reps=5),
            library_ms=_time_ms(lib_min, reps=5),
            bound=_bound_ms(S, N, M, 4)),
    }
    for name, t in timing.items():
        print(f"  time {name:12s} S={S} N=M={N} norm=1: kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, library (cdist+min) {t['library_ms']:.4f} ms, "
              f"bound {t['bound'][0]:.4f} ms ({t['bound'][1]})")
        key = "bidir" if name == "nn_bidir" else "min"
        t["max_abs_err"] = max(v[n][key] for v in out.values() for n in (1, 2))
    return timing


def run_main_path(dev, gpu_line: str) -> dict:
    """Phase 4: the registration path through its public entry point."""
    from autourdf_tpu_torch.config import PipelineConfig
    from autourdf_tpu_torch.ops import knn
    from autourdf_tpu_torch.ops.chamfer import chamfer_distance
    from autourdf_tpu_torch.registration import predicted_world_points
    from autourdf_tpu_torch import workflow

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        os.symlink(os.path.join(REPO, "data_real", "raw"), os.path.join(root, "raw"))
        cfg = PipelineConfig(robot="wx200_real_5", data_root=root, rot="q", epochs=EPOCHS)
        names, frames, masks = workflow.load_raw_sequences_padded(cfg.raw_dir(), cfg.num_videos)
        S, T, N, _ = frames.shape
        ft = torch.from_numpy(frames).to(dev)
        mt = torch.from_numpy(masks).to(dev)
        with torch.no_grad():
            raw = torch.stack([chamfer_distance(ft[:, t], ft[:, t + 1], mt[:, t], mt[:, t + 1])
                               for t in range(T - 1)], dim=1)
        raw_mean = float(raw.mean())

        knn.reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.time()
        stats = workflow.run_registration(cfg, seed=0, corr_every=1, device=dev)
        result = stats.pop("result")
        with torch.no_grad():
            last = predicted_world_points(result, T - 1)
            resid = chamfer_distance(last, ft[:, -1], mt[:, -1], mt[:, -1])
        torch.cuda.synchronize(dev)
        wall = time.time() - t0
        counts = dict(knn.launch_counts)

        missing = [f"{n}/{d}/{t:04}.{ext}" for n in names
                   for d, ext in (("matrix", "npy"), ("cluster", "npz")) for t in range(T)
                   if not os.path.exists(os.path.join(cfg.part_dir(), n, d, f"{t:04}.{ext}"))]

    losses, step_losses = result.losses, result.step_losses
    anchor_mean = float(losses.mean())
    print(f"  {S} sequences x {T} frames x {N} points (ragged, masked), K={cfg.num_segments()}, "
          f"hidden 512, mode q, {EPOCHS} epochs")
    print(f"  mean raw Chamfer between consecutive frames {raw_mean:.6f}; "
          f"mean step-phase loss {float(step_losses.mean()):.6f}; "
          f"mean anchor-phase loss {anchor_mean:.6f}")
    print(f"  registered last frame vs raw last frame (forward-only Chamfer): "
          f"{[round(float(v), 9) for v in resid]}")
    print(f"  registration {stats['seconds']:.3f} s, {stats['frames_per_second']:.4f} frames/s "
          f"({S * (T - 1)} frame pairs); whole phase {wall:.3f} s; card: {gpu_line}")
    print(f"  launches: {counts}")
    if len(names) != 5 or T != 10:
        _fail(f"expected 5 sequences x 10 frames, got {len(names)} x {T}")
    if missing:
        _fail(f"missing artifacts: {missing[:5]}")
    if not (torch.isfinite(losses).all() and torch.isfinite(step_losses).all()):
        _fail("non-finite registration losses")
    if not anchor_mean < raw_mean:
        _fail(f"mean anchor loss {anchor_mean} not below raw Chamfer {raw_mean}")
    if not (torch.isfinite(resid).all() and float(resid.max()) < 1e-4):
        _fail(f"registered points do not reproduce the last frame: {resid.tolist()}")
    if counts["nn_bidir"] != PAIRS * 2 * EPOCHS:
        _fail(f"nn_bidir launched {counts['nn_bidir']} times, expected {PAIRS * 2 * EPOCHS}")
    if counts["nn_min_bidir"] < 1:
        _fail("nn_min_bidir was not launched on the main path")
    return {"counts": counts, "n": N, "stats": stats}


def profile_epochs(dev, n: int, epochs: int = 20) -> None:
    """Where one training epoch's time goes at the main path's shape (5
    sequences, K=20, hidden 512, n points): wall time per epoch without the
    profiler, then the device's busy time per epoch and its top kernels
    from torch.profiler over the same number of epochs."""
    from torch.profiler import ProfilerActivity, profile

    from autourdf_tpu_torch.models.regmlp import PoseRegressor
    from autourdf_tpu_torch.registration.optimizer import train_epochs, train_init

    S, K = 5, 20
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
        train_epochs(model, carry, mats, target, pts, labels, k)
        torch.cuda.synchronize(dev)

    run(3)
    t0 = time.time()
    run(epochs)
    wall_ms = 1e3 * (time.time() - t0) / epochs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(epochs)
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3 / epochs, e.count // epochs)
            for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[1] for r in rows)
    print(f"  per epoch (S={S}, N={n}, K={K}, hidden 512): wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, device idle share {1 - busy / wall_ms:.3f}, "
          f"{sum(r[2] for r in rows)} device kernels")
    for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"    {ms:.4f} ms x{cnt}  {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.config import PipelineConfig
    from autourdf_tpu_torch.ops import _cuda

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[1] device {name} (count {torch.cuda.device_count()}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(gpu_line)

    t0 = time.time()
    _cuda.library("knn")
    print(f"[2] built csrc/knn.cu in {time.time() - t0:.1f} s; ptxas:\n"
          + _cuda.build_logs.get("knn", "(cached)").strip())

    cfg = PipelineConfig(robot="wx200_real_5", data_root=os.path.join(REPO, "data_real"))
    _, frames, _ = workflow.load_raw_sequences_padded(cfg.raw_dir(), cfg.num_videos)
    print("[3] kernels against their plain versions")
    timing = check_kernels(dev, frames.shape[2])

    print("[4] main path: workflow.run_registration on data_real/raw/wx200_real_5")
    main_path = run_main_path(dev, gpu_line)
    print("[4b] where an epoch's time goes")
    profile_epochs(dev, main_path["n"])

    sources = {"nn_bidir": ("autourdf_tpu/ops/knn.py:149"),
               "nn_min_bidir": ("autourdf_tpu/ops/knn.py:313")}
    kernels = []
    for kname, t in timing.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": "autourdf_tpu_torch/csrc/knn.cu",
            "replaces": sources[kname], "launches": main_path["counts"][kname],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
        })
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms", "library_ms")):
            _fail(f"non-finite measurement for {k['name']}")
    print(f"[5] card: {gpu_line}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
