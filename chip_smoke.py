#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (autourdf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on error:

1. print the device and ``nvidia-smi``'s name and power limit;
2. build the CUDA kernels from ``autourdf_tpu_torch/csrc`` (nvcc, sm_90a);
   print ptxas' registers (a spill fails the run) and the SASS instruction
   counts of the four search kernels' inner loops;
3. hold every kernel against its plain PyTorch version on the card (exact
   distances and indices) at the production shape with masked rows and
   forced ties, at a ragged shape and at the main path's shape, the
   one-directional search also at the ICP batch and the carry-test shapes
   and with all-sentinel targets, the accumulator kernel also against the
   per-tile kernel and at 20,000 points, both indexed kernels on cases built
   to break their grouped minima (ties across register groups, sub-tiles,
   blocks and column chunks, ragged edges, the largest M the per-tile kernel
   takes and the first it does not) under planned and forced block shapes,
   and the one-directional and the min-only kernel on the same kind of
   cases (ties across a thread's group, its passes, the warps and, for the
   min-only kernel, column chunks; N < 32 and M < one group; S = 1 and 100;
   all-sentinel targets; the carry shape); check the Chamfer value and
   gradients, farthest-point sampling and one ICP step against the plain
   path on the CPU; time each kernel, its plain version and one library
   call, beside the bound and the floor of unfused fp32 work, and the
   per-tile and accumulator kernels side by side at both sizes, wrapper time
   and device time (the dispatch rule of ops/knn.py), and the
   one-directional kernel also at the carry test's and at a link-ICP shape;
4. the main path: register ``data_real/raw/wx200_real_5`` (5 sequences x 10
   ragged frames, K=20, hidden 512, mode q, 300 epochs) through
   ``workflow.run_registration`` into a temporary data root, check the
   artifacts, the losses and the kernels' launch counts;
5. (printed last) the kernel JSON line, then the result line;
6. the ``urdf`` stage on the artifacts of phase 4: ``workflow.run_build_urdf``
   with ``refine="none", tree="mst"``, once with the registry's DoF and once
   with ``unknown_dof=True, dof_probe=False``; check the URDF, its meshes
   and that the searches went through the one-directional kernel;
7. ``run_registration(mlp_icp=True, use_normals=True)`` with FPS seeds on the
   first 2 sequences x 4 frames of the same scans; check the ICP's launches
   and the loss;
8. the large-cloud path: one sequence of 3 frames of a synthetic 3-link
   hinged chain at 20,000 points per frame through ``run_registration``;
   check that every search took the accumulator kernel, and the loss.

Exits non-zero, printing no result, without a CUDA device or without the
repository around it.
"""

from __future__ import annotations

import collections
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# per (x, y) pair: 3 subtracts, 3 absolute values, 2 adds, 1 compare
OPS_PER_PAIR = 9
# The fp32 peak counts a fused multiply-add as two operations; an L1 distance
# has none to fuse (and the build passes -fmad=false), so its instructions
# run at half the peak: the floor of unfused fp32 work, beside the bound.
UNFUSED_FP32_OPS = PEAK_FP32_FLOPS / 2
# Chamfer value and gradient, kernel path on the card vs the plain path on
# the CPU: the same matched neighbours (exact indices), but sums in another
# order (and index_add_ atomics on the card) move the last bits.
CHAMFER_RTOL, GRAD_ATOL = 1e-5, 1e-7
EPOCHS, PAIRS = 300, 9
# one ICP step, card vs CPU: the same correspondences; the batched 3x3 SVD
# and the weighted sums differ in the last bits
ICP_STEP_ATOL = 1e-5
ICP_ITERATIONS = 30
LARGE_N = 20000
# (S, N, M) of a link-ICP launch of the urdf stage: links x the largest link
# cloud, against itself (phase 6 prints the shapes it launched)
LINK_ICP_SHAPE = (6, 2242, 2242)


# the kernels whose inner loops phase 2 counts (mangled-name fragments): the
# L1 indexed sweeps, the one-directional search at squared L2 and the
# min-only search at L1
SASS_KERNELS = ("nn_bidir_kernelILi1E", "nn_bidir_acc_kernelILi1E", "nn_kernelILi2E",
                "nn_min_bidir_kernelILi1E")


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


def _device_ms_by_kernel(fn, reps: int = 20) -> dict[str, float]:
    """Device time of one call of ``fn`` by device kernel (torch.profiler),
    whatever the host takes to launch them: name -> ms a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):              # a window may come back without device events
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # mean time of a launch times the launches a call makes: the profiler
        # may drop events of a long window, which a plain total / reps would
        # count as time saved
        by = {e.key: (getattr(e, "self_device_time_total", 0.0) / 1e3 / e.count
                      * max(1, round(e.count / reps)))
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0}
        if sum(by.values()) > 0.0:
            return by
    _fail("torch.profiler recorded no device kernel in three windows")


def _device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: the summed time of every device
    kernel it launches."""
    return sum(_device_ms_by_kernel(fn, reps).values())


def _sweep_ms(by_kernel: dict[str, float], kernel: str = "nn_bidir") -> float:
    """Of a wrapper's device kernels, the time of the search kernel alone
    (not the fill, the fold or the unpack beside it).  ``kernel`` is a launch
    counter's name; the default takes either indexed bidirectional kernel."""
    return sum(ms for name, ms in by_kernel.items()
               if (kernel if kernel == "nn_bidir" else f"{kernel}_kernel") in name)


def sass_inner_loop(so_path: str, kernel: str, dump_to: str | None = None) -> dict | None:
    """Instruction counts of ``kernel``'s inner loop in the built library,
    from ``cuobjdump -sass``: the shortest loop (backward branch) that holds
    at least two fifths of the function's FADDs (half, but the compiler may
    keep a second copy of the loop for unaligned loads).  The body of a
    sweep's loop is one column pass of a sub-tile, SWEEP_SUB_ROWS x
    SWEEP_GROUP_COLS pairs, plus the column flush that only a block's last
    sub-tile runs.  Writes the
    function's SASS to ``dump_to`` if given.  None where cuobjdump is
    missing, the function is not in the library or no such loop is found."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    for chunk in text.split("Function : ")[1:]:
        if kernel not in chunk.splitlines()[0]:
            continue
        if dump_to:
            os.makedirs(os.path.dirname(dump_to), exist_ok=True)
            with open(dump_to, "w") as f:
                f.write(chunk)
        ins = [(int(a, 16), op.split(".")[0], rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", chunk)]
        fadds = sum(op == "FADD" for _, op, _ in ins)
        best = None
        for addr, op, rest in ins:
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if target is None or int(target.group(1), 16) >= addr:
                continue
            body = [o for a, o, _ in ins if int(target.group(1), 16) <= a <= addr]
            if 5 * body.count("FADD") >= 2 * fadds and (best is None or len(body) < len(best)):
                best = body
        if best is None:
            return None
        counts = {}
        for op in best:
            counts[op] = counts.get(op, 0) + 1
        return {"total": len(best), "function_total": len(ins),
                "by_opcode": dict(sorted(counts.items(), key=lambda kv: -kv[1]))}
    return None


def _bound_ms(S: int, N: int, M: int, out_bytes_per_point: int,
              both_directions: bool = True) -> tuple[float, str]:
    """Least time for the search: the larger of 9 fp32 operations per pair
    at the fp32 peak and inputs read once + outputs written once at the
    memory rate (outputs for x only when ``both_directions`` is False)."""
    ops = S * N * M * OPS_PER_PAIR
    nbytes = (S * (N + M) * 3 * 4
              + S * (N + (M if both_directions else 0)) * out_bytes_per_point)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _unfused_floor_ms(S: int, N: int, M: int) -> float:
    """The bound's operations at the rate of unfused fp32 instructions."""
    return 1e3 * S * N * M * OPS_PER_PAIR / UNFUSED_FP32_OPS


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
            acc = knn._nn_bidir_acc_cuda(x, y, norm)
            tile = knn._nn_bidir_cuda(x, y, norm)
            err_acc = max(_max_abs(acc[0], ref[0]), _max_abs(acc[2], ref[2]))
            same_acc = all(torch.equal(a, b) for a, b in zip(acc, ref))
            same_tile = all(torch.equal(a, b) for a, b in zip(acc, tile))
            print(f"  nn_bidir_acc {label:10s} S={S} N={N} M={M} norm={norm}: "
                  f"max|d-plain| {err_acc}, equal to plain {same_acc}, to per-tile {same_tile}")
            if err_acc != 0.0 or not same_acc or not same_tile or bool(torch.signbit(acc[2]).any()):
                _fail(f"nn_bidir_acc disagrees with its plain version ({label}, norm {norm})")
            gnn = knn.nn_search(x, y, norm)
            err_nn = _max_abs(gnn[0], ref[0])
            print(f"  nn           {label:10s} S={S} N={N} M={M} norm={norm}: "
                  f"max|d-plain| {err_nn}, indices equal {bool(torch.equal(gnn[1], ref[1]))}")
            if err_nn != 0.0 or not torch.equal(gnn[1], ref[1]):
                _fail(f"nn disagrees with its plain version ({label}, norm {norm})")
            out.setdefault(label, {})[norm] = {"bidir": max(errs), "min": err_min,
                                               "acc": err_acc, "nn": err_nn}

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

    out["extra"] = {n: _check_new_kernel_shapes(dev, n_main, n) for n in (1, 2)}
    out["design"] = {n: _check_sweep_design(dev, n) for n in (1, 2)}
    out["light"] = {n: _check_light_design(dev, n) for n in (1, 2)}
    _check_fps_and_icp(dev)

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
            device_ms=_device_ms(lambda: knn.nn_search_bidirectional(x, y, 1)),
            plain_ms=_time_ms(lambda: knn._nn_bidir_plain(x, y, 1), reps=5),
            library_ms=_time_ms(lib_bidir, reps=5),
            bound=_bound_ms(S, N, M, 4 + 8)),
        "nn_min_bidir": dict(
            ms=_time_ms(lambda: knn.nn_min_bidirectional(x, y, 1)),
            plain_ms=_time_ms(lambda: knn._nn_min_bidir_plain(x, y, 1), reps=5),
            library_ms=_time_ms(lib_min, reps=5),
            bound=_bound_ms(S, N, M, 4)),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_min = _device_ms_by_kernel(lambda: knn.nn_min_bidirectional(x, y, 1))
    timing["nn_min_bidir"].update(device_ms=sum(by_min.values()),
                                  kernel_device_ms=_sweep_ms(by_min, "nn_min_bidir"))
    print(f"  nn_min_bidir S={S} N=M={N} norm=1: device time kernel alone "
          f"{_sweep_ms(by_min, 'nn_min_bidir'):.4f} ms, with its fill "
          f"{sum(by_min.values()):.4f} ms ({len(by_min)} device kernels)")
    _print_plan(knn.plan_bidir(S, N, M, sms, "nn_min_bidir"), sms)
    for name, t in timing.items():
        t["shape"] = f"S={S} N=M={N} norm=1"
        t["unfused_floor_ms"] = _unfused_floor_ms(S, N, M)
    per_tile_small = timing["nn_bidir"]["ms"]
    del x, y

    # the one-directional search at the ICP batch of register --mlp_icp:
    # S * K = 100 clouds of n_main points, squared L2
    xb, yb = _case(np.random.default_rng(3), 100, n_main, n_main, dev, True)

    def lib_nn():
        return torch.cdist(xb, yb).min(-1)

    nn_device = _device_ms(lambda: knn.nn_search(xb, yb, 2), reps=5)
    timing["nn"] = dict(
        ms=_time_ms(lambda: knn.nn_search(xb, yb, 2)),
        device_ms=nn_device, kernel_device_ms=nn_device,        # one device kernel
        unfused_floor_ms=_unfused_floor_ms(100, n_main, n_main),
        plain_ms=_time_ms(lambda: knn._nn_plain(xb, yb, 2), reps=3, warm=1),
        library_ms=_time_ms(lib_nn, reps=3, warm=1),
        bound=_bound_ms(100, n_main, n_main, 4 + 8, both_directions=False),
        shape=f"S=100 N=M={n_main} norm=2")
    _print_plan(knn.plan_bidir(100, n_main, n_main, sms, "nn"), sms)
    del xb, yb
    torch.cuda.empty_cache()
    # ... at the carry test's shape (K*K*P = 25,600 queries against 2,048
    # points, the 9 frame pairs of a sequence in one launch) and at a shape of
    # the urdf stage's link ICP (phase 6 prints the shapes it launches)
    for label, Sc, Nc, Mc in (("carry test", 9, 25600, 2048), ("link ICP", *LINK_ICP_SHAPE)):
        xc, yc = _case(np.random.default_rng(4), Sc, Nc, Mc, dev, False)
        wrapper = _time_ms(lambda: knn.nn_search(xc, yc, 2))
        device = _device_ms(lambda: knn.nn_search(xc, yc, 2))
        bound = _bound_ms(Sc, Nc, Mc, 4 + 8, both_directions=False)
        print(f"  time nn           S={Sc} N={Nc} M={Mc} norm=2 ({label}): wrapper "
              f"{wrapper:.4f} ms, device {device:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
              f"unfused floor {_unfused_floor_ms(Sc, Nc, Mc):.4f} ms")
        _print_plan(knn.plan_bidir(Sc, Nc, Mc, sms, "nn"), sms)
        del xc, yc

    # the accumulator kernel at the large-cloud shape, and both indexed
    # kernels side by side at both sizes: what the dispatch rule rests on
    xs, ys = _case(np.random.default_rng(1), 5, n_main, n_main, dev, True)
    xl, yl = _case(np.random.default_rng(5), 1, 20000, 20000, dev, True)

    def lib_big():
        d = torch.cdist(xl, yl, p=1)
        return d.min(-1), d.min(-2)

    timing["nn_bidir_acc"] = dict(
        ms=_time_ms(lambda: knn._nn_bidir_acc_cuda(xl, yl, 1)),
        device_ms=_device_ms(lambda: knn._nn_bidir_acc_cuda(xl, yl, 1)),
        plain_ms=_time_ms(lambda: knn._nn_bidir_plain(xl, yl, 1), reps=5),
        library_ms=_time_ms(lib_big, reps=5),
        bound=_bound_ms(1, 20000, 20000, 4 + 8),
        unfused_floor_ms=_unfused_floor_ms(1, 20000, 20000),
        shape="S=1 N=M=20000 norm=1")
    library = {5: timing["nn_bidir"]["library_ms"], 1: timing["nn_bidir_acc"]["library_ms"]}
    faster = {}
    for xa, ya in ((xs, ys), (xl, yl)):
        Sa, Na, Ma = xa.shape[0], xa.shape[1], ya.shape[1]
        shape = f"S={Sa} N=M={Na}"
        fns = {"nn_bidir": knn._nn_bidir_cuda, "nn_bidir_acc": knn._nn_bidir_acc_cuda}
        # wrapper time in turns (per-tile, accumulator, accumulator, per-tile),
        # then the device time of each wrapper's kernels and of the search
        # kernel alone
        order = ("nn_bidir", "nn_bidir_acc", "nn_bidir_acc", "nn_bidir")
        wall = [_time_ms(lambda f=fns[k]: f(xa, ya, 1)) for k in order]
        by = {k: _device_ms_by_kernel(lambda f=f: f(xa, ya, 1)) for k, f in fns.items()}
        bound, floor = _bound_ms(Sa, Na, Ma, 4 + 8)[0], _unfused_floor_ms(Sa, Na, Ma)
        for k, w in (("nn_bidir", (wall[0], wall[3])), ("nn_bidir_acc", (wall[1], wall[2]))):
            plan = knn.plan_bidir(Sa, Na, Ma, sms, k)
            print(f"  {k:12s} {shape} norm=1: wrapper {w[0]:.4f} / {w[1]:.4f} ms; device time "
                  f"kernel alone {_sweep_ms(by[k]):.4f} ms, whole wrapper "
                  f"{sum(by[k].values()):.4f} ms ({len(by[k])} device kernels); bound "
                  f"{bound:.4f} ms, unfused floor {floor:.4f} ms, library "
                  f"{library[Sa]:.4f} ms")
            _print_plan(plan, sms)
        dev_tile, dev_acc = sum(by["nn_bidir"].values()), sum(by["nn_bidir_acc"].values())
        picks = knn.pick_bidir_plan(Sa, Na, Ma, sms)
        faster[shape] = "per-tile" if dev_tile <= dev_acc else "accumulator"
        print(f"  per-tile vs accumulator {shape} norm=1: wrapper per-tile {wall[0]:.4f} / "
              f"{wall[3]:.4f} ms, accumulator {wall[1]:.4f} / {wall[2]:.4f} ms; device time "
              f"per-tile {dev_tile:.4f} ms, accumulator {dev_acc:.4f} ms "
              f"({dev_acc / dev_tile:.3f} of per-tile); dispatch takes the "
              f"{'per-tile' if picks.kernel == 'nn_bidir' else 'accumulator'} kernel")
        if Sa == 5:
            timing["nn_bidir"]["kernel_device_ms"] = _sweep_ms(by["nn_bidir"])
        else:
            timing["nn_bidir_acc"]["kernel_device_ms"] = _sweep_ms(by["nn_bidir_acc"])
    print(f"  dispatch rule (ops/knn.py pick_bidir_plan): the per-tile kernel where it takes the "
          f"shape (8 * M bytes of column state fit a block) and its scratch is at most "
          f"ACC_SCRATCH_BYTES = {knn.ACC_SCRATCH_BYTES / 1e6:.1f} MB, else the accumulator; "
          f"faster in device time in this run: {faster}")
    print(f"  (indexed wrapper at S=5 also measured above in this run: {per_tile_small:.4f} ms)")

    keys = {"nn_bidir": "bidir", "nn_min_bidir": "min", "nn": "nn", "nn_bidir_acc": "acc"}
    for name, t in timing.items():
        print(f"  time {name:12s} {t['shape']}: kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, library (cdist+min) "
              f"{t['library_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms ({t['bound'][1]}), "
              f"unfused floor {t['unfused_floor_ms']:.4f} ms")
        t["max_abs_err"] = max(v[n][keys[name]] for v in out.values() for n in (1, 2)
                               if keys[name] in v[n])
    return timing


def _print_plan(plan, sms: int) -> None:
    print(f"    plan: {plan.rows} rows x {plan.cols} columns a block, {plan.threads} "
          f"threads, grid {plan.grid} = {plan.blocks} blocks, "
          f"{plan.blocks_per_sm:.2f} a SM on {sms} SMs, {plan.resident} resident a SM, "
          f"{plan.waves:.2f} waves, {plan.shared_bytes} bytes of shared memory, "
          f"{plan.scratch_bytes / 1e6:.1f} MB of scratch")


def _check_new_kernel_shapes(dev, n_main: int, norm: int) -> dict:
    """The shapes only the two new kernels meet: the ICP batch (100 clouds,
    some targets all at the sentinel, as an AABB gate that leaves no point),
    the carry test (25,600 queries against 2,048 points) and 20,000-point
    clouds with forced ties across many tiles."""
    from autourdf_tpu_torch.ops import knn

    rng = np.random.default_rng(6 + norm)
    errs = {"nn": 0.0, "acc": 0.0}
    x, y = _case(rng, 100, n_main, n_main, dev, True)
    y[::7] = knn.PAD_COORD                      # every 7th target: no point left
    got, ref = knn.nn_search(x, y, norm), knn._nn_plain(x, y, norm)
    ok = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    gated_ok = bool((got[1][::7] == 0).all() and torch.isfinite(got[0]).all())
    errs["nn"] = max(errs["nn"], _max_abs(got[0], ref[0]))
    print(f"  nn           ICP batch  S=100 N=M={n_main} norm={norm}: equal to plain {ok}, "
          f"all-sentinel targets give index 0 at a finite distance {gated_ok}")
    if not ok or not gated_ok:
        _fail(f"nn disagrees with its plain version (ICP batch, norm {norm})")
    del x, y, got, ref
    x, y = _case(rng, 2, 25600, 2048, dev, False)
    y[:, 1000:1100] = y[:, :100]
    got, ref = knn.nn_search(x, y, norm), knn._nn_plain(x, y, norm)
    ok = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    errs["nn"] = max(errs["nn"], _max_abs(got[0], ref[0]))
    print(f"  nn           carry test S=2 N=25600 M=2048 norm={norm}: equal to plain {ok}")
    if not ok:
        _fail(f"nn disagrees with its plain version (carry shape, norm {norm})")
    del x, y, got, ref
    x, y = _case(rng, 1, 20000, 20000, dev, True)
    x[:, 11::37] = y[:, 5:6]                    # one column's minimum in ~540 rows, many tiles
    got, ref = knn._nn_bidir_acc_cuda(x, y, norm), knn._nn_bidir_plain(x, y, norm)
    auto = knn.nn_search_bidirectional(x, y, norm)
    ok = all(torch.equal(a, b) for a, b in zip(got, ref))
    ok_auto = all(torch.equal(a, b) for a, b in zip(auto, ref))
    errs["acc"] = max(_max_abs(got[0], ref[0]), _max_abs(got[2], ref[2]))
    first = int(got[3][0, 5])
    print(f"  nn_bidir_acc large      S=1 N=M=20000 norm={norm}: equal to plain {ok} (through "
          f"the dispatch {ok_auto}), tied column takes row {first} (first of the tied rows: 11), "
          f"any -0.0 {bool(torch.signbit(got[2]).any())}")
    if not ok or not ok_auto or first != 11 or bool(torch.signbit(got[2]).any()):
        _fail(f"nn_bidir_acc disagrees with its plain version (20,000 points, norm {norm})")
    return errs


def tie_layout_clouds(rng, S: int, N: int, M: int):
    """Clouds built to break the indexed sweep's grouped minima: x rows equal
    to a y point (zero distances) and copied to rows 1, 2, 5, 33, 70, ...
    further on, so that a column's minimum is reached in one register group,
    in several groups of a sub-tile, in several sub-tiles of a block and in
    several blocks, whatever the rows per block; the y point copied to
    columns 1, 3, 4, 9, 130, ... further on, so that a row's minimum is
    reached in one thread's group, in several threads, in several passes and
    in several column chunks.  Row 11 and every 37th after it are one more
    y point: one column whose minimum many blocks reach."""
    x = rng.uniform(-0.3, 0.3, (S, N, 3)).astype(np.float32)
    y = rng.uniform(-0.3, 0.3, (S, M, 3)).astype(np.float32)
    if M > 5:
        x[:, 11::37] = y[:, 5:6]
    for b, j in ((0, 0), (38, 6), (130, 65), (N // 2 + 1, M // 2 + 3), (N - 2, M - 2)):
        if not (0 <= b < N and 0 <= j < M):
            continue
        x[:, b] = y[:, j]
        for off in (1, 2, 5, 33, 70, 131, 259, 1027, 2051):
            if b + off < N:
                x[:, b + off] = x[:, b]
        for off in (1, 3, 4, 9, 130, 515, 1030, 2052, 2499, 2600):
            if j + off < M:
                y[:, j + off] = y[:, j]
    return x, y


def _check_sweep_design(dev, norm: int) -> dict:
    """Cases built against the indexed sweep's design, for both kernels, each
    under the planned block shape and under forced ones (one sub-tile a block,
    many sub-tiles, many threads, narrow column chunks): exact against the
    plain version, hence equal to each other."""
    from autourdf_tpu_torch.ops import knn

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(20 + norm)
    cases = []
    for label, S, N, M in (("ties ragged", 2, 4989, 4987), ("ties small", 3, 130, 67),
                           ("ties S=1", 1, 300, 257), ("ties S=100", 100, 300, 257)):
        cases.append((label, *tie_layout_clouds(rng, S, N, M)))
    xz = rng.uniform(-0.3, 0.3, (2, 700, 3)).astype(np.float32)
    cases.append(("all-sentinel y", xz, np.full((2, 333, 3), knn.PAD_COORD, np.float32)))
    errs = {"bidir": 0.0, "acc": 0.0}
    for label, xn, yn in cases:
        x, y = torch.from_numpy(xn).to(dev), torch.from_numpy(yn).to(dev)
        S, N, M = x.shape[0], x.shape[1], y.shape[1]
        ref = knn._nn_bidir_plain(x, y, norm)
        forced = [("nn_bidir", 64, M, 128), ("nn_bidir", 256, M, 512), ("nn_bidir", 32, M, 256),
                  ("nn_bidir_acc", 32, 256, 128), ("nn_bidir_acc", 96, 1024, 256),
                  ("nn_bidir_acc", 160, 2560, 128)]
        plans = [knn.plan_bidir(S, N, M, sms, k) for k in ("nn_bidir", "nn_bidir_acc")]
        plans += [knn.make_plan(S, N, M, sms, *f) for f in forced]
        ok = True
        for plan in plans:
            got = knn._launch_sweep(x, y, norm, plan)
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            key = "bidir" if plan.kernel == "nn_bidir" else "acc"
            errs[key] = max(errs[key], _max_abs(got[0], ref[0]), _max_abs(got[2], ref[2]))
            if not same or bool(torch.signbit(got[2]).any()) or bool(torch.signbit(got[0]).any()):
                ok = False
                print(f"    MISMATCH {label} norm={norm} under {plan}")
        print(f"  sweep design {label:14s} S={S} N={N} M={M} norm={norm}: both kernels under "
              f"{len(plans)} block shapes equal to plain {ok}")
        if not ok:
            _fail(f"an indexed kernel disagrees with its plain version ({label}, norm {norm})")

    # the largest M the per-tile kernel takes, and the first it does not:
    # that one goes to the accumulator by the planning rule
    m_max = max(m for m in range(28000, 29500) if knn.plan_bidir(1, 100, m, sms, "nn_bidir"))
    for M in (m_max, m_max + 1):
        xn, yn = tie_layout_clouds(rng, 1, 100, M)
        x, y = torch.from_numpy(xn).to(dev), torch.from_numpy(yn).to(dev)
        ref = knn._nn_bidir_plain(x, y, norm)
        before = dict(knn.launch_counts)
        got = knn.nn_search_bidirectional(x, y, norm)
        took = [k for k in ("nn_bidir", "nn_bidir_acc") if knn.launch_counts[k] > before[k]]
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        refused = False
        try:
            direct = knn._nn_bidir_cuda(x, y, norm)
            same = same and all(torch.equal(a, b) for a, b in zip(direct, ref))
        except ValueError:
            refused = True
        print(f"  per-tile limit S=1 N=100 M={M} norm={norm}: dispatch took {took}, equal to "
              f"plain {same}, per-tile wrapper refuses the shape {refused}")
        want = (["nn_bidir"], False) if M == m_max else (["nn_bidir_acc"], True)
        if not same or (took, refused) != want:
            _fail(f"per-tile limit: M={M} took {took}, refused {refused} (norm {norm})")
    return errs


def _check_light_design(dev, norm: int) -> dict:
    """Cases built against the design of the one-directional and the min-only
    kernel, each under the planned block shape and under forced ones (one
    warp a block, many warps, one sub-tile, many sub-tiles, narrow column
    chunks for the min-only kernel): exact against the plain versions."""
    from autourdf_tpu_torch.ops import knn

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(40 + norm)
    cases = []
    for label, S, N, M in (("ties ragged", 2, 4989, 4987), ("ties small", 3, 130, 67),
                           ("N<32 M<4", 1, 20, 3), ("ties S=1", 1, 300, 257),
                           ("ties S=100", 100, 300, 257), ("ties carry", 2, 25600, 2048)):
        cases.append((label, *tie_layout_clouds(rng, S, N, M)))
    xz = rng.uniform(-0.3, 0.3, (2, 700, 3)).astype(np.float32)
    cases.append(("all-sentinel y", xz, np.full((2, 333, 3), knn.PAD_COORD, np.float32)))
    # (rows, cols (None: all of y), threads); only the min-only kernel cuts y
    forced = [(32, None, 32), (32, None, 256), (512, None, 64), (96, None, 128),
              (256, None, 256), (64, 256, 128), (160, 1024, 64)]
    errs = {"nn": 0.0, "min": 0.0}
    for label, xn, yn in cases:
        x, y = torch.from_numpy(xn).to(dev), torch.from_numpy(yn).to(dev)
        S, N, M = x.shape[0], x.shape[1], y.shape[1]
        refs = {"nn": knn._nn_plain(x, y, norm), "nn_min_bidir": knn._nn_min_bidir_plain(x, y, norm)}
        plans = [knn.plan_bidir(S, N, M, sms, k) for k in refs]
        for rows, cols, threads in forced:
            if cols is None:
                plans.append(knn.make_plan(S, N, M, sms, "nn", rows, M, threads))
            plans.append(knn.make_plan(S, N, M, sms, "nn_min_bidir", rows, cols or M, threads))
        ok = True
        for plan in plans:
            got, ref = knn._launch_sweep(x, y, norm, plan), refs[plan.kernel]
            key = "nn" if plan.kernel == "nn" else "min"
            errs[key] = max(errs[key], _max_abs(got[0], ref[0]),
                            0.0 if key == "nn" else _max_abs(got[1], ref[1]))
            if (not all(torch.equal(a, b) for a, b in zip(got, ref, strict=True))
                    or bool(torch.signbit(got[0]).any())):
                ok = False
                print(f"    MISMATCH {label} norm={norm} under {plan}")
        sentinel_ok = True
        if label == "all-sentinel y":
            d, i = knn.nn_search(x, y, norm)
            sentinel_ok = bool((i == 0).all() and torch.isfinite(d).all())
        print(f"  light design {label:14s} S={S} N={N} M={M} norm={norm}: nn and nn_min_bidir "
              f"under {len(plans)} block shapes equal to plain {ok}"
              + ("" if label != "all-sentinel y"
                 else f", index 0 at a finite distance {sentinel_ok}"))
        if not ok or not sentinel_ok:
            _fail(f"nn or nn_min_bidir disagrees with its plain version ({label}, norm {norm})")
    return errs


def _check_fps_and_icp(dev) -> None:
    """Farthest-point sampling's first-index argmax and one batched ICP step
    (one entry without any inlier) on the card against the CPU."""
    from autourdf_tpu_torch.ops.fps import farthest_point_sample
    from autourdf_tpu_torch.ops.icp import icp_point_to_point

    rng = np.random.default_rng(8)
    pts = rng.uniform(-0.3, 0.3, (5000, 3)).astype(np.float32)
    pts[2500:2700] = pts[:200]                  # duplicated points: equal scores
    mask = torch.from_numpy(np.arange(5000) >= 9)
    p = torch.from_numpy(pts)
    same = torch.equal(farthest_point_sample(p.to(dev), 20, mask.to(dev)).cpu(),
                       farthest_point_sample(p, 20, mask))
    src = torch.from_numpy(rng.normal(scale=0.1, size=(4, 3000, 3)).astype(np.float32))
    tgt = src + torch.tensor([0.01, -0.02, 0.015])
    tgt[3] += 5.0                               # no inlier within the threshold
    res = [icp_point_to_point(src.to(d), tgt.to(d), max_iterations=1, threshold=0.5)
           for d in (dev, torch.device("cpu"))]
    err = _max_abs(res[0].transform.cpu(), res[1].transform)
    kept = torch.equal(res[0].transform[3].cpu(), torch.eye(4))
    print(f"  fps on the card equals the CPU (first index on ties): {same}; one ICP step, card vs "
          f"CPU: max abs err {err:.3g} (tol {ICP_STEP_ATOL}), no-inlier entry keeps its init {kept}")
    if not same or not err <= ICP_STEP_ATOL or not kept:
        _fail("fps or ICP on the card disagrees with the CPU path")


def run_main_path(dev, gpu_line: str, root: str) -> dict:
    """Phase 4: the registration path through its public entry point, into
    the data root ``root`` (phase 6 builds the URDF from its artifacts)."""
    from autourdf_tpu_torch.config import PipelineConfig
    from autourdf_tpu_torch.ops import knn
    from autourdf_tpu_torch.ops.chamfer import chamfer_distance
    from autourdf_tpu_torch.registration import predicted_world_points
    from autourdf_tpu_torch import workflow

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
    return {"counts": counts, "n": N, "stats": stats, "cfg": cfg}


def run_urdf_stage(dev, cfg) -> dict:
    """Phase 6 (Path B): structure -> joints -> meshes -> URDF from the
    artifacts of phase 4, with the known DoF and with the DoF search."""
    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.ops import knn

    knn.reset_launch_counts()
    for label, kw in (("known DoF", dict(unknown_dof=False)),
                      ("unknown DoF, no probe", dict(unknown_dof=True, dof_probe=False))):
        before = knn.launch_counts["nn"]
        shapes: collections.Counter = collections.Counter()
        launch = knn._launch_sweep

        def recording(x, y, norm, plan):
            shapes[(plan.kernel, x.shape[0], x.shape[1], y.shape[1], norm)] += 1
            return launch(x, y, norm, plan)

        knn._launch_sweep = recording       # the shapes this build launches
        t0 = time.time()
        try:
            out = workflow.run_build_urdf(cfg, refine="none", tree="mst", end_video=5,
                                          verbose=False, device=dev, **kw)
        finally:
            knn._launch_sweep = launch
        torch.cuda.synchronize(dev)
        seconds = time.time() - t0
        launched = knn.launch_counts["nn"] - before
        print(f"  {label}: launches by (kernel, S, N, M, norm): {dict(shapes.most_common())}")
        robot = ET.parse(out["urdf_path"]).getroot()
        links, joints = robot.findall("link"), robot.findall("joint")
        stls = [m.get("filename") for m in robot.iter("mesh")]
        axes = np.array([[float(v) for v in j.find("axis").get("xyz").split()] for j in joints])
        print(f"  {label}: {out['num_links']} links, dof {out['dof']}, {len(joints)} joints, "
              f"{len(set(stls))} meshes, {seconds:.3f} s, nn launches {launched}")
        if len(links) != out["num_links"] or len(joints) != out["num_links"] - 1:
            _fail(f"URDF has {len(links)} links and {len(joints)} joints for "
                  f"{out['num_links']} links ({label})")
        if out["num_links"] < 2:
            _fail(f"no articulation found ({label})")
        bad = [f for f in stls if not (os.path.exists(f) and os.path.getsize(f) > 84)]
        if bad or len(set(stls)) != out["num_links"]:
            _fail(f"missing or empty meshes: {bad[:3]} ({label})")
        if not np.allclose(np.linalg.norm(axes, axis=1), 1.0, atol=1e-6):
            _fail(f"a joint axis is not a unit vector ({label})")
        if not np.all(np.isfinite(axes)) or launched < 1:
            _fail(f"the urdf stage did not go through the nn kernel ({label})")
    return {"counts": dict(knn.launch_counts)}


def _raw_chamfer(dev, frames, masks) -> float:
    """Mean Chamfer-L1 between consecutive raw frames of every sequence."""
    from autourdf_tpu_torch.ops.chamfer import chamfer_distance

    ft = torch.from_numpy(frames).to(dev)
    mt = None if masks is None else torch.from_numpy(masks).to(dev)
    with torch.no_grad():
        raw = [chamfer_distance(ft[:, t], ft[:, t + 1],
                                None if mt is None else mt[:, t],
                                None if mt is None else mt[:, t + 1])
               for t in range(ft.shape[1] - 1)]
    return float(torch.stack(raw).mean())


def run_icp_path(dev, root: str) -> dict:
    """Phase 7 (Path A): register --mlp_icp --normal --seed-mode fps on the
    first 2 sequences x 4 frames of the real scans, at full width."""
    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.config import PipelineConfig
    from autourdf_tpu_torch.ops import knn

    S, T = 2, 4
    src = os.path.join(REPO, "data_real", "raw", "wx200_real_5")
    for seq in sorted(os.listdir(src))[:S]:
        os.makedirs(os.path.join(root, "raw", "wx200_real_5", seq))
        for frame in sorted(os.listdir(os.path.join(src, seq)))[:T]:
            os.symlink(os.path.join(src, seq, frame),
                       os.path.join(root, "raw", "wx200_real_5", seq, frame))
    cfg = PipelineConfig(robot="wx200_real_5", data_root=root, rot="q", epochs=EPOCHS,
                         num_videos=S, seed_mode="fps")
    _, frames, masks = workflow.load_raw_sequences_padded(cfg.raw_dir(), S)
    raw_mean = _raw_chamfer(dev, frames, masks)
    knn.reset_launch_counts()
    stats = workflow.run_registration(cfg, seed=0, mlp_icp=True, use_normals=True, device=dev)
    torch.cuda.synchronize(dev)
    counts = dict(knn.launch_counts)
    result = stats.pop("result")
    print(f"  {frames.shape[0]} sequences x {frames.shape[1]} frames x {frames.shape[2]} points, "
          f"K={cfg.num_segments()}, hidden 512, {EPOCHS} epochs, mlp_icp, normals, FPS seeds: "
          f"{stats['seconds']:.3f} s; mean raw Chamfer {raw_mean:.6f}, mean loss "
          f"{stats['mean_loss']:.6f}")
    print(f"  launches: {counts} (ICP: {T - 1} pairs x {ICP_ITERATIONS} iterations, one launch "
          f"for the whole batch of {S} x {cfg.num_segments()} clusters)")
    if frames.shape[:2] != (S, T):
        _fail(f"expected {S} sequences x {T} frames, got {frames.shape[:2]}")
    if counts["nn"] != (T - 1) * ICP_ITERATIONS:
        _fail(f"nn launched {counts['nn']} times, expected {(T - 1) * ICP_ITERATIONS}")
    if counts["nn_bidir"] != (T - 1) * EPOCHS:
        _fail(f"nn_bidir launched {counts['nn_bidir']} times, expected {(T - 1) * EPOCHS}")
    if not (torch.isfinite(result.matrices).all() and stats["mean_loss"] < raw_mean):
        _fail(f"mean loss {stats['mean_loss']} not below raw Chamfer {raw_mean}")
    return {"counts": counts, "seconds": stats["seconds"]}


def articulated_chain_frames(num_frames: int, n: int, seed: int = 0) -> np.ndarray:
    """``(T, n, 3)`` clouds of a 3-link hinged chain: a base box, an arm
    turning about z at the base's end, a forearm turning about y at the
    arm's end.  Every frame samples the three surfaces anew (as a scanner
    would), so even the static base differs between frames."""
    rng = np.random.default_rng(seed)
    boxes = [(np.array([-0.25, 0.0, 0.0]), np.array([0.25, 0.08, 0.06])),
             (np.array([0.2, 0.0, 0.0]), np.array([0.2, 0.04, 0.04])),
             (np.array([0.15, 0.0, 0.0]), np.array([0.15, 0.03, 0.03]))]
    share = np.array([0.5, 0.3, 0.2])
    counts = np.floor(share * n).astype(int)
    counts[0] += n - counts.sum()

    def rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        return (np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) if axis == 2
                else np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]))

    def surface(center, half, k):
        pts = rng.uniform(-1, 1, (k, 3))
        face = rng.integers(0, 3, k)
        pts[np.arange(k), face] = np.sign(pts[np.arange(k), face])
        return center + pts * half

    frames = []
    for t in range(num_frames):
        r1, r2 = rot(2, 0.15 * t), rot(1, -0.2 * t)
        base = surface(*boxes[0], counts[0])
        arm = surface(*boxes[1], counts[1]) @ r1.T
        fore = (surface(*boxes[2], counts[2]) @ r2.T + [0.4, 0.0, 0.0]) @ r1.T
        frames.append(np.concatenate([base, arm, fore]) + rng.normal(0, 5e-4, (n, 3)))
    return np.stack(frames).astype(np.float32)


def run_large_cloud_path(dev, root: str) -> dict:
    """Phase 8: one sequence of 3 frames at 20,000 points per frame through
    the registration entry point: every search takes the accumulator kernel."""
    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.config import PipelineConfig
    from autourdf_tpu_torch.io.ply import write_ply
    from autourdf_tpu_torch.ops import knn

    T = 3
    cfg = PipelineConfig(robot="wx200_5", data_root=root, rot="q", epochs=EPOCHS, num_videos=1)
    frames = articulated_chain_frames(T, LARGE_N)
    for t in range(T):
        write_ply(os.path.join(cfg.raw_dir(), "V0000", f"{t:04}", "robot.ply"), frames[t])
    raw_mean = _raw_chamfer(dev, frames[None], None)
    knn.reset_launch_counts()
    stats = workflow.run_registration(cfg, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    counts = dict(knn.launch_counts)
    result = stats.pop("result")
    expected = (T - 1) * 2 * EPOCHS
    print(f"  1 sequence x {T} frames x {LARGE_N} points (synthetic 3-link chain), "
          f"K={cfg.num_segments()}, hidden 512, {EPOCHS} epochs: {stats['seconds']:.3f} s; mean raw "
          f"Chamfer {raw_mean:.6f}, mean step-phase loss {stats['mean_step_loss']:.6f}, mean "
          f"anchor-phase loss {stats['mean_loss']:.6f}")
    print(f"  launches: {counts}")
    if counts["nn_bidir_acc"] != expected or counts["nn_bidir"] != 0:
        _fail(f"expected {expected} accumulator launches and no per-tile launch, got {counts}")
    if not (torch.isfinite(result.losses).all() and stats["mean_loss"] < raw_mean):
        _fail(f"mean anchor loss {stats['mean_loss']} not below raw Chamfer {raw_mean}")
    return {"counts": counts, "seconds": stats["seconds"]}


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
    log = _cuda.build_logs.get("knn", "(cached)").strip()
    print(f"[2] built csrc/knn.cu in {time.time() - t0:.1f} s; ptxas:\n{log}")
    spills = [ln.strip() for ln in log.splitlines()
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    if spills:
        _fail(f"a kernel spills registers: {spills[:2]}")
    from autourdf_tpu_torch.ops.knn import SWEEP_GROUP_COLS, SWEEP_SUB_ROWS

    pairs = SWEEP_SUB_ROWS * SWEEP_GROUP_COLS
    for kname in SASS_KERNELS:
        sass = sass_inner_loop(_cuda.build("knn"), kname)
        if sass is None:
            _fail(f"the SASS of {kname}'s inner loop could not be counted: cuobjdump (CUDA "
                  f"toolkit) is missing or no loop of the function holds its distances")
        print(f"  SASS inner loop of {kname} (one column pass of a sub-tile, {pairs} pairs, with "
              f"the column flush, if any, of the last sub-tile): {sass['total']} instructions = "
              f"{sass['total'] / pairs:.2f} a pair; {sass['by_opcode']}")

    cfg = PipelineConfig(robot="wx200_real_5", data_root=os.path.join(REPO, "data_real"))
    _, frames, _ = workflow.load_raw_sequences_padded(cfg.raw_dir(), cfg.num_videos)
    print("[3] kernels against their plain versions")
    timing = check_kernels(dev, frames.shape[2])

    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        roots = {k: os.path.join(tmp, k) for k in ("main", "icp", "large")}
        for r in roots.values():
            os.makedirs(r)
        print("[4] main path: workflow.run_registration on data_real/raw/wx200_real_5")
        paths["register"] = main_path = run_main_path(dev, gpu_line, roots["main"])
        print("[4b] where an epoch's time goes")
        profile_epochs(dev, main_path["n"])
        print("[6] path B: workflow.run_build_urdf(refine='none', tree='mst') on the artifacts "
              "of [4]")
        paths["urdf"] = run_urdf_stage(dev, main_path["cfg"])
        print("[7] path A: workflow.run_registration(mlp_icp=True, use_normals=True), FPS seeds")
        paths["register_icp"] = run_icp_path(dev, roots["icp"])
        print("[8] large clouds: workflow.run_registration at 20,000 points per frame")
        paths["register_large"] = run_large_cloud_path(dev, roots["large"])

    sources = {"nn_bidir": "autourdf_tpu/ops/knn.py:149",
               "nn_min_bidir": "autourdf_tpu/ops/knn.py:313",
               "nn": "autourdf_tpu/ops/knn.py:54",
               "nn_bidir_acc": "autourdf_tpu/ops/knn.py:233"}
    kernels = []
    for kname, t in timing.items():
        by_path = {pname: p["counts"][kname] for pname, p in paths.items()}
        kernels.append({
            "name": kname, "route": "cuda", "source": "autourdf_tpu_torch/csrc/knn.cu",
            "replaces": sources[kname], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "shape": t["shape"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "device_ms": t["device_ms"],
            "kernel_device_ms": t.get("kernel_device_ms"), "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
        })
        if kernels[-1]["launches"] < 1:
            _fail(f"kernel {kname} was launched on no path")
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                 "library_ms")):
            _fail(f"non-finite measurement for {k['name']}")
    print(f"[5] card: {gpu_line}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
