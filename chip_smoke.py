#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (autourdf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on error:

1. print the device and ``nvidia-smi``'s name and power limit;
2. build the CUDA kernels from ``autourdf_tpu_torch/csrc`` (one nvcc a
   source, ``knn.cu``, ``geom.cu`` and ``optim.cu`` started together;
   sm_90a); print
   ptxas' registers (a spill fails the run) and the SASS instruction counts
   of the four search kernels' inner loops;
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
   and device time (the dispatch rule of ops/knn.py), the one-directional
   kernel also at the carry test's and at a link-ICP shape, and the
   one-directional (squared L2) and min-only (L1) kernels at the evaluation's
   re-simulation shape, S=1, N=M=10,000; then the three geometry kernels of
   ``csrc/geom.cu`` against their plain versions: ``fps_kernel`` (its
   cluster of 16 blocks, shared bytes, registers and spills printed;
   identical picks at a capture's real visible set of [11]'s robot, masked
   and compacted, k = 5,000; at 10,000 of 10,000 points; on 100,000 points
   with a duplicated block and a mask; with fewer valid points than k and
   with none; on 400,003 points, beyond the blocks' shared memory; on
   1,100,003 points, ranges past 16-bit offsets; on fewer points than
   blocks; with one pick; with k above a valid count spread over the
   blocks; with every valid point in one block's range; timed at the
   dataset's and the evaluation's capture shapes beside its step skeleton
   and k empty cluster barriers), ``icp_kabsch_kernel``, one ICP
   iteration after the search in one launch (B x N = 1 x 10,000, 6 x
   2,250, 2 x 1,024, 100 x 4,988 with 5% of the weights on, 18 x 1,500;
   masked, no-inlier, empty-gate, reflected, frozen, planar (H of rank 2)
   and collinear (rank 1) entries: T to 1e-5 where the rotation is unique
   (all but the collinear), the next moved cloud to 1e-5, fitness equal,
   RMSE to 1e-5 relative, proper rotations to 1e-6, T kept where there is
   nothing to fit or the entry is frozen) and ``pca_normals_kernel``, the
   normals after the top-k in one launch (30-neighbourhoods of one real
   frame and of a 20,000-point cloud: |dot| > 1 - 1e-4 where the two smallest eigenvalues
   are 10% apart, the same sign where |n_z| > 1e-3, unit norm to 1e-6, n_z
   >= 0), each timed beside its bound and its plain version (no one PyTorch
   call computes any of the three); then ``epoch_update_kernel``
   (``csrc/optim.cu``), the epoch's Adam, plateau step, best tracking and
   freeze in one launch, against the plain chain (every field of the carry
   and the masked loss bit for bit, three epochs each at the main path's
   shape and at three small odd ones), timed beside its bound and the plain
   chain with the flat gradient's assembly.  After [3] no path may call
   ``torch.linalg.svd``, ``det`` or ``eigh`` on a CUDA tensor;
4. the main path: register ``data_real/raw/wx200_real_5`` (5 sequences x 10
   ragged frames, K=20, hidden 512, mode q, 300 epochs) through
   ``workflow.run_registration`` into a temporary data root, check the
   artifacts, the losses and the kernels' launch counts (the epoch's
   update one an epoch);
5. (printed last) the kernel JSON line, then the result line;
6. the ``urdf`` stage on the artifacts of phase 4: ``workflow.run_build_urdf``
   with ``refine="none", tree="mst"``, once with the registry's DoF and once
   with ``unknown_dof=True, dof_probe=False``; check the URDF, its meshes
   and that the searches went through the one-directional kernel;
7. ``run_registration(mlp_icp=True, use_normals=True)`` with FPS seeds on the
   first 2 sequences x 4 frames of the same scans, its ICP phase and normals
   resample as programs; check the launches of the ICP's search and Kabsch
   step kernels, of the normals kernel and of the farthest-point pick, the
   captures (their graph nodes printed) and the loss;
8. the large-cloud path: one sequence of 3 frames of a synthetic 3-link
   hinged chain at 20,000 points per frame through ``run_registration``;
   check that every search took the accumulator kernel, and the loss;
9. the ``urdf`` stage with the JAX package's defaults on the artifacts of
   phase 4 (the 1,200-step kinematic-chain fit in its veto loop, the motion
   tree arbitrated against the MST, with the unknown DoF the probe ladder):
   known DoF, then unknown; print the fits, veto passes, freeze deltas and
   the launches by shape; check that every fit lowered its loss, the URDF
   and that the searches went through the accumulator, min-only and
   one-directional kernels; 9b: wall and device time of a chain-fit step on
   each build's links;
10. the chain fit's opt-in options once (two anchors, a three-step
    canonical union, the truncated Chamfer; 100 steps);
11. the closed loop: ``autourdf_tpu_torch.cli.main(["all", ...])`` at the JAX
    CLI's defaults on the tracked wx200 estimate
    (``data_ab5/urdf/wx200_5_20_seg``), given as a parameters JSON: simulate
    5 sequences x 10 frames (20 cameras at 800 px, 5,000 of 200,000 surface
    points), register them, build the URDF with the unknown DoF and the
    defaults, score it (joint errors, re-simulation Chamfer at 3
    configurations, the gt-vs-gt floor); check every stage's output, the
    telemetry and that the four search kernels, the farthest-point pick and
    the Kabsch kernel were launched; time each stage, one capture and its
    farthest-point pick (one launch), and the native meshing against the
    numpy extractor (the native host library must build);
12. the parallel layer with several ranks on the one card
    (``parallel.launch.run``, gloo with CUDA tensors), each rank's result
    held against the single-process path on the card: [12a]
    ``sharded_chamfer`` over 2 ranks at N = M = 131,072 and at N = 100,003,
    M = 131,071 with bool masks (loss, both gradients, every nearest index);
    [12b] ``chamfer_distance`` inside ``mesh_scope`` at M = 40,000 shards by
    itself; [12c] ``train_step_dp_sp`` on a (2, 2) mesh (4 ranks) with four
    of [11]'s sequences, K=20, hidden 512, 300 epochs, as programs (each
    epoch program A, the two all-reduces, program B; a first call with its
    captures and a second that replays) and eagerly, all three equal to the
    single-process path bit for bit, with the program calls and the
    all-reduces an epoch counted; [12d]
    ``register_sequences_sharded`` over 2 ranks, four of [11]'s sequences x 3
    frames; every rank must launch the search kernels, and the wall times
    say nothing of multi-card scaling;
13. ``cli view --sweep --interactive`` on [11]'s recovered URDF: the
    snapshot, the HTML scene and one GIF a revolute joint, each read back by
    the script's own PNG and GIF readers.

14. the registration from the JAX package's draw: the real scans (5 x 10
    frames, K=20, hidden 512, 300 epochs) through ``register_sequences_batched``
    from the init of ``tests/data/same_draw_wx200_real_5_seed0.npz`` (the JAX
    package's registration from its own segmentation at seed 0 and the port's
    MLP weights, ``scripts/torch_same_draw.py record``) and
    ``workflow._draw_weights(5, 0)``, whose checksum must be the record's;
    print per sequence and pair the gaps of the best losses, poses and labels,
    the first pair and phase beyond the tolerance, on pair 0->1 the epoch at
    which each phase's loss history leaves the record's, and the port's
    structure on both registrations beside the record's; fail on a gap at
    pair 0->1 beyond ``SAME_DRAW_CPU_GAP x SAME_DRAW_FACTOR``, on a port
    build of the record's registration that is not the record's JAX build,
    or on another structure where the registrations agree (losses within the
    tolerance, poses within ``SAME_DRAW_POSE_ATOL``, the same labels).

15. the device programs (``autourdf_tpu_torch/utils/programs.py``, CUDA
    graphs) against the eager loops: phase 4c's subset, and the same with
    phase 7's options, through the eager loop, the batched driver's phase
    programs and the fused frame-pair program; phase 9b's chain fit for 120
    steps eager and in 50-step programs; the first link ICP of [6], polish
    ICP of [10] and resim ICP of [11] on their own arguments, eager, in a
    fresh program and replayed (wall ms of each), and against the plain loop
    (its step in plain PyTorch) on the card, T to 1e-4; every output of a
    program must equal the eager loop's bit for bit and every program's
    capture and instantiation seconds, graph nodes and pool bytes are
    printed.

16. the revolute-joint fit: ``refine_joints`` (200 Adam steps a joint,
    point_cap 2,048) on the joints, links and first ``CoordMap`` of [6]'s
    known-DoF build, eager, in its chunk programs and replayed (first the
    search kernel at the fits' shape against its plain version): every fit and
    refined joint equal bit for bit, with the same launches and at least one
    indexed search; unit axes, ``thetas[0] == 0``, finite losses; wall ms a
    step, the captures, and each fit's gap to the CPU port from the same
    inputs over its first 25 steps (not gated).

The main path of phases 4, 4c, 9, 11 and 14 runs the programs (phase 4
prints its captures).  Phase 4b times a training epoch and phase 9b a
chain-fit step eagerly and in programs: wall ms, the device's busy ms and the
idle share.  Phase 4c registers the first 2 sequences x 4 frames of the real
scans twice at seed 0 and fails unless the two runs are equal, bit for bit.
The script prints its total seconds before the card's line.

Phase 3 also holds the three kernels of a chain-fit step (S = 50 clouds of
6 x 1,024 model points against the frames) against their plain versions
and times them there.

Exits non-zero, printing no result, without a CUDA device or without the
repository around it.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import importlib
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
# order move the last bits.
CHAMFER_RTOL, GRAD_ATOL = 1e-5, 1e-7
EPOCHS, PAIRS = 300, 9
# one ICP step, card vs CPU: the same correspondences; the Kabsch kernel's
# Jacobi SVD against LAPACK's, and the weighted sums, differ in the last bits
ICP_STEP_ATOL = 1e-5
ICP_ITERATIONS = 30
LARGE_N = 20000
# (S, N, M) of a link-ICP launch of the urdf stage: links x the largest link
# cloud, against itself (phase 6 prints the shapes it launched)
LINK_ICP_SHAPE = (6, 2242, 2242)
# (S, N) of a gradient step of the urdf stage's chain fit: 5 sequences x 10
# steps in one batch, 6 links x 1,024 model points, against the frames
# (M = the main path's padded frame size)
CHAIN_S, CHAIN_N = 50, 6 * 1024
# (S, N, M) of the evaluation's re-simulation: one capture of 10,000 points
# against another (the ICP's one-directional search at squared L2, the
# Chamfer's min-only search at L1)
RESIM_SHAPE = (1, 10000, 10000)
# the closed loop's ground truth: the tracked estimate of the wx200 (6 links,
# 5 revolute joints, STL meshes under data_ab5/mesh/), in the frame it was
# captured in
WX200_ESTIMATE = os.path.join("data_ab5", "urdf", "wx200_5_20_seg", "4_deg_20_cams.urdf")
CLOSED_LOOP_SEQS, CLOSED_LOOP_FRAMES, CLOSED_LOOP_POINTS = 5, 10, 5000
# fp32 operations of a farthest-point step a valid point (3 subtracts, 3
# multiplies, 2 adds, the minimum, the key's compare), for its bound
FPS_OPS_PER_POINT = 10
# [3]: a cloud whose 16 blocks' ranges (25,001 points each) overflow their
# shared memory (about 12,900 points a block), so every block streams the
# rest; and one whose ranges (68,751) pass 16-bit offsets, so the winners'
# original indices come from device memory
FPS_OVERFLOW_N, FPS_WIDE_N = 400003, 1100003
# picks of an evaluation capture (400 px), timed beside the dataset's
FPS_EVAL_POINTS = 10000
# [3]: the ICP sites' shapes, (B entries, N points against as many): resim,
# link, polish, --mlp_icp (S K = 5 x 20 clusters, about 5% of the weights
# on), a 14-link build's link ICP
ICP_STEP_SHAPES = ((1, 10000), (6, 2250), (2, 1024), (100, 4988), (18, 1500))
ICP_MLP_DENSITY = 0.05
# _icp_step_case's kinds of entry whose H has rank 2 and rank 1
ICP_PLANAR, ICP_COLLINEAR = 6, 7
# the fused Kabsch step against its plain version: T and moved (the same
# correspondences; a Jacobi SVD against the solver's, sums in another
# order), RMSE relative
ICP_T_ATOL, ICP_RMSE_RTOL = 1e-5, 1e-5
# [15]: a site's whole ICP (30 or 50 iterations) with the kernel against the
# plain loop on the card, T
SITE_ICP_T_ATOL = 1e-4
# bytes a point of the fused Kabsch step: moved 12, index 8, the gathered
# match 12, d2 4, weight 4, the source read and the next moved written 24;
# fp32 operations a point: the gate 4, pass 1 15, pass 2 27, the next moved
# 18 (the 3x3 work, some 1,600 an entry, is below the bound's precision)
ICP_STEP_BYTES_PER_POINT, ICP_STEP_OPS_PER_POINT = 64, 64
# the normals' neighbours (registration/pipeline.py, segments.py)
PCA_K = 30


# [3]: the epoch's update at the main path's shape: 5 sequences, mode q,
# hidden 512 (P = 425,991), K = 20; bytes a parameter: its gradient, theta,
# mu and nu read, theta, mu and nu written
UPDATE_S, UPDATE_K, UPDATE_HIDDEN = 5, 20, 512
UPDATE_BYTES_PER_PARAM = 28

# the kernel sources of autourdf_tpu_torch/csrc that phase 2 builds
CUDA_SOURCES = ("knn", "geom", "optim")

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

        # Chamfer through autograd (indexed kernel + scatter-add backward) and
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
    resim = _check_resim_shape(dev)
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
        plain = _time_ms(lambda: knn._nn_plain(xc, yc, 2), reps=5)
        library = _time_ms(lambda: torch.cdist(xc, yc).min(-1), reps=5)
        bound = _bound_ms(Sc, Nc, Mc, 4 + 8, both_directions=False)
        print(f"  time nn           S={Sc} N={Nc} M={Mc} norm=2 ({label}): wrapper "
              f"{wrapper:.4f} ms, device {device:.4f} ms, plain {plain:.4f} ms, "
              f"library (cdist+min) {library:.4f} ms, "
              f"bound {bound[0]:.4f} ms ({bound[1]}), "
              f"unfused floor {_unfused_floor_ms(Sc, Nc, Mc):.4f} ms")
        _print_plan(knn.plan_bidir(Sc, Nc, Mc, sms, "nn"), sms)
        del xc, yc
        torch.cuda.empty_cache()
    timing["chain"] = _check_chain_shape(dev, n_main, sms)
    timing["resim"] = resim

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
        if name not in keys:
            continue
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


def _check_chain_shape(dev, n_main: int, sms: int) -> dict:
    """The search of one chain-fit gradient step (S = 50 clouds of 6 x 1,024
    model points against the frames, L1, masked rows and forced ties): the
    accumulator kernel (which the dispatch takes here), the per-tile kernel
    forced onto the shape, and the min-only kernel of the freeze probe's
    forward-only evaluations, each exact against its plain version, and
    timed with its plain version, one library call and the bound.  Returns
    kernel -> measurements, for the kernels line."""
    from autourdf_tpu_torch.ops import _cuda, knn

    S, N, M = CHAIN_S, CHAIN_N, n_main
    x, y = _case(np.random.default_rng(9), S, N, M, dev, True)
    ref = knn._nn_bidir_plain(x, y, 1)
    rmin = knn._nn_min_bidir_plain(x, y, 1)
    pick = knn.pick_bidir_plan(S, N, M, sms)
    fns = {"nn_bidir_acc": lambda: knn.nn_search_bidirectional(x, y, 1),
           "nn_bidir": lambda: knn._nn_bidir_cuda(x, y, 1),
           "nn_min_bidir": lambda: knn.nn_min_bidirectional(x, y, 1)}
    before = dict(_cuda.launch_counts)
    got = {k: f() for k, f in fns.items()}
    took = [k for k in _cuda.launch_counts if _cuda.launch_counts[k] > before[k]]
    errs = {k: max(_max_abs(got[k][0], ref[0]), _max_abs(got[k][2], ref[2]))
            for k in ("nn_bidir_acc", "nn_bidir")}
    same = {k: all(torch.equal(a, b) for a, b in zip(got[k], ref)) for k in errs}
    errs["nn_min_bidir"] = max(_max_abs(got["nn_min_bidir"][0], rmin[0]),
                               _max_abs(got["nn_min_bidir"][1], rmin[1]))
    same["nn_min_bidir"] = errs["nn_min_bidir"] == 0.0
    print(f"  chain shape S={S} N={N} M={M} norm=1: dispatch picks {pick.kernel} (per-tile "
          f"scratch would be {S * -(-N // knn.plan_bidir(S, N, M, sms, 'nn_bidir').rows) * M * 8 / 1e6:.1f} MB"
          f" > ACC_SCRATCH_BYTES {knn.ACC_SCRATCH_BYTES / 1e6:.1f} MB); launched {sorted(took)}; "
          f"equal to plain {same}")
    if pick.kernel != "nn_bidir_acc" or not all(same.values()):
        _fail(f"chain shape: dispatch took {pick.kernel}, exactness {same}")
    del got, ref, rmin
    torch.cuda.empty_cache()

    def lib_bidir():
        d = torch.cdist(x, y, p=1)
        return d.min(-1), d.min(-2)

    def lib_min():
        d = torch.cdist(x, y, p=1)
        return d.amin(-1), d.amin(-2)

    library = {"bidir": _time_ms(lib_bidir, reps=3, warm=1)}
    torch.cuda.empty_cache()
    library["min"] = _time_ms(lib_min, reps=3, warm=1)
    torch.cuda.empty_cache()
    out = {}
    # wrapper times in turns: accumulator, per-tile, per-tile, accumulator
    order = ("nn_bidir_acc", "nn_bidir", "nn_bidir", "nn_bidir_acc")
    wall = [_time_ms(fns[k], reps=10) for k in order]
    walls = {"nn_bidir_acc": (wall[0], wall[3]), "nn_bidir": (wall[1], wall[2]),
             "nn_min_bidir": (_time_ms(fns["nn_min_bidir"], reps=10),)}
    for k in fns:
        by = _device_ms_by_kernel(fns[k], reps=5)
        plain = (knn._nn_min_bidir_plain if k == "nn_min_bidir" else knn._nn_bidir_plain)
        bound = _bound_ms(S, N, M, 4 if k == "nn_min_bidir" else 4 + 8)
        out[k] = dict(shape=f"S={S} N={N} M={M} norm=1", ms=min(walls[k]),
                      device_ms=sum(by.values()), kernel_device_ms=_sweep_ms(by, k),
                      plain_ms=_time_ms(lambda: plain(x, y, 1), reps=2, warm=1),
                      library_ms=library["min" if k == "nn_min_bidir" else "bidir"],
                      bound_ms=bound[0], bound_by=bound[1], max_abs_err=errs[k],
                      unfused_floor_ms=_unfused_floor_ms(S, N, M))
        torch.cuda.empty_cache()
        t = out[k]
        print(f"  time {k:12s} chain shape S={S} N={N} M={M} norm=1: wrapper "
              f"{' / '.join(f'{w:.4f}' for w in walls[k])} ms, device {t['device_ms']:.4f} ms "
              f"(kernel alone {t['kernel_device_ms']:.4f} ms, {len(by)} device kernels), plain "
              f"{t['plain_ms']:.4f} ms, library (cdist+min) {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), unfused floor "
              f"{t['unfused_floor_ms']:.4f} ms")
        _print_plan(knn.plan_bidir(S, N, M, sms, k), sms)
    print(f"  per-tile vs accumulator at the chain shape: device time per-tile "
          f"{out['nn_bidir']['device_ms']:.4f} ms, accumulator {out['nn_bidir_acc']['device_ms']:.4f} "
          f"ms ({out['nn_bidir_acc']['device_ms'] / out['nn_bidir']['device_ms']:.3f} of per-tile)")
    del x, y
    torch.cuda.empty_cache()
    return out


def _check_resim_shape(dev) -> dict:
    """The two searches of the evaluation's re-simulation at S=1, N=M=10,000:
    the one-directional kernel at squared L2 (the ICP) and the min-only
    kernel at L1 (the Chamfer), on clouds with forced ties, exact against
    their plain versions, and timed with the plain version, one library
    call (cdist + min) and the bound.  Returns kernel -> measurements."""
    from autourdf_tpu_torch.ops import knn

    S, N, M = RESIM_SHAPE
    xn, yn = tie_layout_clouds(np.random.default_rng(11), S, N, M)
    x, y = torch.from_numpy(xn).to(dev), torch.from_numpy(yn).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def lib_min():
        d = torch.cdist(x, y, p=1)
        return d.amin(-1), d.amin(-2)

    cases = {
        "nn": dict(norm=2, fn=lambda: knn.nn_search(x, y, 2), plain=lambda: knn._nn_plain(x, y, 2),
                   library=lambda: torch.cdist(x, y).min(-1),
                   bound=_bound_ms(S, N, M, 4 + 8, both_directions=False)),
        "nn_min_bidir": dict(norm=1, fn=lambda: knn.nn_min_bidirectional(x, y, 1),
                             plain=lambda: knn._nn_min_bidir_plain(x, y, 1), library=lib_min,
                             bound=_bound_ms(S, N, M, 4)),
    }
    out = {}
    for k, c in cases.items():
        got, ref = c["fn"](), c["plain"]()
        same = all(torch.equal(a, b) for a, b in zip(got, ref, strict=True))
        err = _max_abs(got[0], ref[0])
        by = _device_ms_by_kernel(c["fn"])
        t = dict(shape=f"S={S} N=M={N} norm={c['norm']}", ms=_time_ms(c["fn"]),
                 device_ms=sum(by.values()), kernel_device_ms=_sweep_ms(by, k),
                 plain_ms=_time_ms(c["plain"], reps=5), library_ms=_time_ms(c["library"], reps=5),
                 bound_ms=c["bound"][0], bound_by=c["bound"][1], max_abs_err=err,
                 unfused_floor_ms=_unfused_floor_ms(S, N, M))
        out[k] = t
        print(f"  {k:12s} resim shape {t['shape']}: equal to plain {same} (max|d-plain| {err}); "
              f"wrapper {t['ms']:.4f} ms, device {t['device_ms']:.4f} ms (kernel alone "
              f"{t['kernel_device_ms']:.4f} ms, {len(by)} device kernels), plain "
              f"{t['plain_ms']:.4f} ms, library (cdist+min) {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), unfused floor "
              f"{t['unfused_floor_ms']:.4f} ms")
        _print_plan(knn.plan_bidir(S, N, M, sms, k), sms)
        if not same:
            _fail(f"{k} disagrees with its plain version at the resim shape")
    del x, y
    torch.cuda.empty_cache()
    return out


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
    from autourdf_tpu_torch.ops import _cuda, knn

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
        before = dict(_cuda.launch_counts)
        got = knn.nn_search_bidirectional(x, y, norm)
        took = [k for k in ("nn_bidir", "nn_bidir_acc") if _cuda.launch_counts[k] > before[k]]
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


def _fps_times(dev, points: torch.Tensor, mask: torch.Tensor, k: int) -> dict:
    """fps_kernel on ``points`` under ``mask`` with ``k`` picks: wrapper ms
    (CUDA events, median of 10) and device ms (torch.profiler); in the same
    launch shape, the device ms of the step skeleton (16 points, one a
    block: every step's reductions, barrier and slot reads with no point
    work) and the ms of k empty cluster barriers (CUDA events), the floor of
    a pick that synchronises once a step; printed."""
    from autourdf_tpu_torch.ops import _cuda, fps

    lib = _cuda.library("geom")

    def barriers():
        _cuda.check(lib.geom_cluster_barriers_launch(k, _cuda.stream(points)), "barriers")

    one_each = points[:: max(1, points.shape[0] // fps.CLUSTER_BLOCKS)][:fps.CLUSTER_BLOCKS]
    out = dict(ms=_time_ms(lambda: fps.farthest_point_sample(points, k, mask), reps=10, warm=2),
               device_ms=_device_ms(lambda: fps.farthest_point_sample(points, k, mask), reps=5),
               skeleton_ms=_device_ms(lambda: fps.farthest_point_sample(one_each, k), reps=5),
               barrier_floor_ms=_time_ms(barriers, reps=10, warm=2))
    n_valid = int(mask.sum())
    print(f"  time fps     N={points.shape[0]} ({n_valid} valid) k={k}: wrapper {out['ms']:.4f} "
          f"ms, device {out['device_ms']:.4f} ms ({out['device_ms'] / k * 1e3:.3f} us a step); "
          f"the step skeleton (16 points) {out['skeleton_ms']:.4f} ms, {k} empty cluster "
          f"barriers {out['barrier_floor_ms']:.4f} ms ({out['barrier_floor_ms'] / k * 1e3:.3f} us "
          f"a barrier)")
    return out


def _ptxas_lines(log: str, kernel: str) -> list[str]:
    """ptxas' lines (``-Xptxas -v``) for the functions whose mangled name
    holds ``kernel``: properties, spills, registers."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            keep = kernel in ln
        if keep:
            out.append(ln.strip())
    return out


def _rotvecs(v: np.ndarray) -> np.ndarray:
    """``(B, 3, 3)`` rotations of the rotation vectors ``v (B, 3)``
    (Rodrigues)."""
    angle = np.linalg.norm(v, axis=1)[:, None, None]
    k = v / np.maximum(angle[:, :, 0], 1e-30)
    K = np.zeros((len(v), 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _icp_step_case(dev, B: int, n: int, density: float, seed: int):
    """One ICP step's inputs on the card, as ``tests/torch_geom_models.py
    icp_step_inputs`` makes them: entry e of kind e % 8, 0 dense, 1 masked
    (half the weights), 2 no inlier (the target 5 away), 3 the cloud mirrored
    about its centre (a reflected H), 4 frozen (done), 5 an empty gate
    (every target a sentinel), 6 planar (z = 0: H of rank 2, a flat link
    face), 7 collinear (y = z = 0: rank 1, a thin cluster; its rotation
    about the line is free); every weight kept with probability
    ``density``.  The correspondences are the identity and d2 their squared
    distances.  Returns ``(args, state, kind)``: ``ops/icp.py
    kabsch_step(*args, *state)``, state = (T, fitness, rmse, done)."""
    from autourdf_tpu_torch.ops.knn import PAD_COORD

    rng = np.random.default_rng(seed)
    kind = np.arange(B) % 8
    src = rng.normal(scale=[0.12, 0.08, 0.05], size=(B, n, 3)) + rng.normal(0, 0.3, (B, 1, 3))
    src[kind == ICP_PLANAR, :, 2] = 0.0
    src[kind == ICP_COLLINEAR, :, 1:] = 0.0
    tgt = np.einsum("bij,bnj->bni", _rotvecs(rng.normal(0, 0.1, (B, 3))), src)
    tgt += rng.normal(0, 0.01, (B, 1, 3))
    centre = src.mean(1, keepdims=True)
    tgt[kind == 3] = ((src - centre) * [1.0, 1.0, -1.0] + centre)[kind == 3]
    tgt += rng.normal(0, 2e-3, tgt.shape)
    tgt[kind == 2] += 5.0
    tgt[kind == 5] = PAD_COORD
    w = rng.random((B, n)) < density
    w[kind == 1] &= rng.random((int((kind == 1).sum()), n)) < 0.5
    T = np.tile(np.eye(4), (B, 1, 1))
    T[:, :3, :3] = _rotvecs(rng.normal(0, 1.0, (B, 3)))
    T[:, :3, 3] = rng.normal(0, 0.2, (B, 3))
    source = np.einsum("bji,bnj->bni", T[:, :3, :3], src - T[:, None, :3, 3])
    src, tgt, source, T, w = (torch.from_numpy(a.astype(np.float32)).to(dev)
                              for a in (src, tgt, source, T, w))
    crit = tuple(torch.full((), v, device=dev) for v in (0.25, 1e-6, 1e-6))
    args = (source, src, tgt, torch.arange(n, device=dev).repeat(B, 1),
            torch.sum((src - tgt) ** 2, dim=-1), w, torch.clamp_min(w.sum(1), 1e-12), crit)
    state = (T, torch.full((B,), 0.5, device=dev), torch.full((B,), 0.01, device=dev),
             torch.from_numpy(kind == 4).to(dev))
    return args, state, kind


def _separated(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbourhoods whose two smallest eigenvalues (of the centred
    covariance, float64 on the CPU) are more than 10% apart (and apart by
    more than the fp32 round-off of the matrix, 1e-4 of its largest
    eigenvalue)."""
    nb = points.detach().cpu().double()[idx.cpu()]
    c = nb - nb.mean(1, keepdim=True)
    e = torch.linalg.eigvalsh(torch.einsum("nki,nkj->nij", c, c))
    gap = e[:, 1] - e[:, 0]
    return (gap > 0.1 * e[:, 1]) & (gap > 1e-4 * e[:, 2])


def check_geom_kernels(dev, frame: np.ndarray) -> dict:
    """Phase 3 for csrc/geom.cu: farthest-point sampling (identical picks),
    the ICP's fused Kabsch step at the ICP sites' shapes (T to 1e-5 but at
    rank 1, fitness equal, RMSE to 1e-5 relative, moved to 1e-5, proper
    rotations to 1e-6, masked, no-inlier, empty-gate, reflected, frozen,
    planar and collinear entries) and the
    fused normals (|dot| > 1 - 1e-4 where separated, unit norm to 1e-6, n_z
    >= 0) against their plain versions on the card, then their times at the
    main path's shapes.  ``frame`` is one real scan (its valid points)."""
    from autourdf_tpu_torch.ops import _cuda, fps, icp, plane
    from autourdf_tpu_torch.sim import KinematicEnv
    from autourdf_tpu_torch.sim.capture import visible_mask

    # -- fps_kernel: the cluster, then identical picks
    setup = fps.cluster_setup(dev)
    print(f"  fps_kernel: one cluster of {fps.CLUSTER_BLOCKS} blocks x {fps.BLOCK_THREADS} "
          f"threads; the card holds {setup.max_clusters} such clusters at once; dynamic shared "
          f"memory up to {setup.shared_max} bytes a block; {setup.registers} registers a "
          f"thread, {setup.local_bytes} local bytes (cudaFuncGetAttributes); ptxas:")
    for ln in _ptxas_lines(_cuda.build_logs.get("geom", ""), "fps_kernel"):
        print(f"    {ln}")
    if setup.local_bytes:
        _fail(f"fps_kernel spills: {setup.local_bytes} local bytes a thread")
    env = KinematicEnv.create(os.path.join(REPO, WX200_ESTIMATE), dof=5, radius=1.5,
                              num_cameras=20, camera_rng=np.random.default_rng(0), device=dev)
    env.set_joint_positions(np.array([0.3, -0.2, 0.4, 0.1, -0.3]))
    surface = torch.from_numpy(env.posed_surface_points()).to(dev)
    vis = visible_mask(surface, env.rig, 800, 800).any(0)
    vis_idx = torch.nonzero(vis)[:, 0]
    vis400 = visible_mask(surface, env.rig, 400, 400).any(0)
    rng = np.random.default_rng(12)
    uniform = torch.from_numpy(rng.uniform(-0.3, 0.3, (100000, 3)).astype(np.float32)).to(dev)
    uniform[50000:52000] = uniform[:2000]                  # a duplicated block: equal scores
    half = torch.from_numpy(rng.random(100000) > 0.5).to(dev)
    few = torch.zeros(100000, dtype=torch.bool, device=dev)
    few[[11, 4000, 4001, 70000, 99999]] = True
    big = torch.from_numpy(rng.uniform(-0.3, 0.3, (FPS_OVERFLOW_N, 3)).astype(np.float32)).to(dev)
    big[200000:203000] = big[:3000]
    one_block = torch.zeros(100000, dtype=torch.bool, device=dev)
    block = -(-100000 // fps.CLUSTER_BLOCKS)
    one_block[7 * block:8 * block] = True                  # all of block 7's range, no other
    spread = torch.from_numpy(np.arange(100000) % 997 == 3).to(dev)
    wide = torch.from_numpy(rng.uniform(-0.3, 0.3, (FPS_WIDE_N, 3)).astype(np.float32)).to(dev)
    wide_mask = torch.from_numpy(rng.random(FPS_WIDE_N) > 0.3).to(dev)
    cases = [
        ("capture's visible set, masked", surface, CLOSED_LOOP_POINTS, vis,
         lambda: vis_idx[fps._fps_plain(surface[vis_idx], CLOSED_LOOP_POINTS)]),
        ("capture's visible set, compacted", surface[vis_idx], CLOSED_LOOP_POINTS, None, None),
        ("resim, 10,000 of 10,000", uniform[:10000], 10000, None, None),
        ("100,000 uniform, duplicates, mask", uniform, 1000, half, None),
        ("fewer valid than k", uniform, 50, few, None),
        ("no valid point", uniform, 20, torch.zeros_like(few), None),
        ("beyond shared memory (every block streams)", big, 2000, None, None),
        ("ranges past 16-bit offsets", wide, 100, wide_mask, None),
        ("fewer points than blocks", uniform[:11], 30, None, None),
        ("one pick", uniform, 1, half, None),
        ("k above the valid count, spread over the blocks", uniform, 200, spread, None),
        ("every valid point in one block's range", uniform, 500, one_block, None),
    ]
    fps_err = 0.0                       # the largest difference of two picked indices
    for label, pts, k, mask, plain in cases:
        got = fps.farthest_point_sample(pts, k, mask)
        ref = plain() if plain is not None else fps._fps_plain(pts, k, mask)
        same = torch.equal(got, ref)
        if got.shape == ref.shape:
            fps_err = max(fps_err, float((got - ref).abs().max()))
        cap, nbytes = fps.shared_plan(dev, pts.shape[0])
        print(f"  fps          {label}: N={pts.shape[0]}, valid "
              f"{pts.shape[0] if mask is None else int(mask.sum())}, k={k}: picks equal {same} "
              f"({cap} points, {nbytes} dynamic shared bytes a block)")
        if not same:
            _fail(f"fps_kernel disagrees with its plain version ({label})")

    # -- icp_kabsch_kernel: one launch a step, one cluster an entry
    setup = icp.cluster_setup(dev)
    print(f"  icp_kabsch_kernel: clusters of 1..8 blocks x 256 threads, the card holds "
          f"{setup.max_clusters} of each size at once; {setup.registers} registers a thread, "
          f"{setup.local_bytes} local bytes; ptxas:")
    for ln in _ptxas_lines(_cuda.build_logs.get("geom", ""), "icp_kabsch_kernel"):
        print(f"    {ln}")
    if setup.local_bytes:
        _fail(f"icp_kabsch_kernel spills: {setup.local_bytes} local bytes a thread")
    step_err, step_times = 0.0, {}
    for B, n in ICP_STEP_SHAPES:
        density = ICP_MLP_DENSITY if B == 100 else 1.0
        args, state, kind = _icp_step_case(dev, B, n, density, seed=B + n)
        got = [t.clone() for t in state]
        ref = [t.clone() for t in state]
        before = _cuda.launch_counts["icp_kabsch"]
        moved = icp.kabsch_step(args[0], args[1].clone(), *args[2:], *got)
        launched = _cuda.launch_counts["icp_kabsch"] - before
        ref_moved = icp._kabsch_step_plain(*args, *ref)
        unique = torch.from_numpy(kind != ICP_COLLINEAR).to(dev)
        err = float((got[0] - ref[0]).abs()[unique].max())

        def err_of(k):
            sel = torch.from_numpy(kind == k).to(dev)
            return float((got[0] - ref[0]).abs()[sel].max()) if bool(sel.any()) else None
        err_refl, err_planar = err_of(3), err_of(ICP_PLANAR)
        fit_eq = torch.equal(got[1], ref[1]) and torch.equal(got[3], ref[3])
        rmse_ok = bool(((got[2] - ref[2]).abs() <= ICP_RMSE_RTOL * ref[2].abs()).all())
        rmse_rel = float(((got[2] - ref[2]).abs() / ref[2].abs().clamp_min(1e-30)).max())
        moved_err = float((moved - ref_moved).abs().max())
        R = got[0][:, :3, :3].double()
        orth_all = (R @ R.transpose(-1, -2) - torch.eye(3, device=dev, dtype=torch.float64)).abs()
        det_all = (torch.linalg.det(R) - 1).abs()
        orth, det = float(orth_all.max()), float(det_all.max())
        low_rank = torch.from_numpy(np.isin(kind, (ICP_PLANAR, ICP_COLLINEAR))).to(dev)
        proper_low = (f"planar and collinear: max |R R^T - I| "
                      f"{float(orth_all[low_rank].max()):.3g}, |det R - 1| "
                      f"{float(det_all[low_rank].max()):.3g}"
                      if bool(low_rank.any()) else "no planar or collinear entry")
        kept_idx = torch.from_numpy(np.isin(kind, (2, 4, 5))).to(dev)
        kept = torch.equal(got[0][kept_idx], state[0][kept_idx])
        empty = torch.from_numpy(np.isin(kind, (2, 5))).to(dev)
        zeros = not bool(got[1][empty].any() or got[2][empty].any())
        step_err = max(step_err, err)
        print(f"  icp_kabsch   B={B} N=M={n} ({icp.cluster_blocks(n)} blocks a cluster, weights "
              f"{density:g}): max |T - plain| {err:.3g} (tol {ICP_T_ATOL}, all but the "
              f"collinear; reflected H {err_refl}, planar {err_planar}), fitness and done equal "
              f"{fit_eq}, max RMSE rel err {rmse_rel:.3g} (tol {ICP_RMSE_RTOL}), max |moved - "
              f"plain| {moved_err:.3g} (tol {ICP_T_ATOL}); max |R R^T - I| {orth:.3g}, |det R - 1| "
              f"{det:.3g} (tol 1e-6; {proper_low}); no-inlier, empty-gate and frozen entries "
              f"keep T {kept}, fitness = RMSE = 0 {zeros}; launches {launched}")
        if not (launched == 1 and err <= ICP_T_ATOL and fit_eq and rmse_ok
                and moved_err <= ICP_T_ATOL and orth <= 1e-6 and det <= 1e-6 and kept and zeros):
            _fail(f"icp_kabsch_kernel disagrees with its plain step (B={B}, N={n})")
        st = [t.clone() for t in state]
        mv = args[1].clone()
        step = lambda: icp.kabsch_step(args[0], mv, *args[2:], *st)  # noqa: E731
        step_times[f"B={B} N={n}"] = t = dict(
            ms=_time_ms(step), device_ms=_device_ms(step),
            plain_ms=_time_ms(lambda: icp._kabsch_step_plain(*args, *st), reps=5),
            bound_ms=1e3 * max(B * n * ICP_STEP_BYTES_PER_POINT / PEAK_BYTES_PER_S,
                               B * n * ICP_STEP_OPS_PER_POINT / PEAK_FP32_FLOPS))
        print(f"  time icp_kabsch B={B} N={n}: wrapper {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f} ms); plain step {t['plain_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.6f} ms (bytes)")

    # the fixed cost of a step: one entry of 32 points (the launch, both
    # passes' reductions and cluster barriers, the 3x3 chain of one thread)
    args, state, _ = _icp_step_case(dev, 1, 32, 1.0, seed=0)
    st, mv = [t.clone() for t in state], args[1].clone()
    skeleton_ms = _device_ms(lambda: icp.kabsch_step(args[0], mv, *args[2:], *st))
    print(f"  time icp_kabsch skeleton (B=1, N=32): device {skeleton_ms:.4f} ms")

    # -- pca_normals_kernel
    normals_err = 0.0
    chain = torch.from_numpy(articulated_chain_frames(1, LARGE_N)[0]).to(dev)
    for label, pts in (("one real frame", torch.from_numpy(frame).to(dev)),
                       ("20,000-point chain", chain)):
        idx = plane.neighbour_indices(pts, PCA_K)
        before = _cuda.launch_counts["pca_normals"]
        v = plane.pca_normals(pts, idx)
        launched = _cuda.launch_counts["pca_normals"] - before
        ref = plane._pca_normals_plain(pts, idx)
        sep = _separated(pts, idx).to(dev)
        dots = (v * ref).sum(1)
        worst = float(1 - dots.abs()[sep].min())
        aligned = torch.where(dots[:, None] < 0, -v, v)
        err = float((aligned - ref).abs()[sep].max())
        steep = sep & (ref[:, 2].abs() > 1e-3)
        flips = int((dots[steep] < 0).sum())
        unit = float((v.norm(dim=1) - 1).abs().max())
        up = bool((v[:, 2] >= 0).all())
        normals_err = max(normals_err, err)
        print(f"  pca_normals  {label}: N={pts.shape[0]}, k={PCA_K}, {int(sep.sum())} separated: "
              f"1 - min |dot| {worst:.3g} (tol 1e-4), max |v - plain| (sign aligned) {err:.3g}; "
              f"opposite signs where |n_z| > 1e-3: {flips}; max |norm - 1| {unit:.3g} (tol 1e-6); "
              f"n_z >= 0 {up}; launches {launched}")
        if not (launched == 1 and worst < 1e-4 and flips == 0 and unit <= 1e-6 and up):
            _fail(f"pca_normals_kernel disagrees with its plain version ({label})")

    # -- times at the main path's shapes
    n_vis = int(vis.sum())
    fr = torch.from_numpy(frame).to(dev)
    fr_idx = plane.neighbour_indices(fr, PCA_K)
    N = fr.shape[0]
    P, k = surface.shape[0], CLOSED_LOOP_POINTS
    B, n = ICP_STEP_SHAPES[3]
    mlp = step_times[f"B={B} N={n}"]

    def bound(ops: float, nbytes: float) -> tuple[float, str]:
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
        return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    fps_eval = _fps_times(dev, surface, vis400, FPS_EVAL_POINTS)
    fps_eval["shape"] = f"N={P} ({int(vis400.sum())} visible) k={FPS_EVAL_POINTS}"
    fps_eval["bound_ms"] = bound((FPS_EVAL_POINTS - 1) * int(vis400.sum()) * FPS_OPS_PER_POINT,
                                 P * (12 + 1) + FPS_EVAL_POINTS * 8)[0]
    fps_eval["plain_ms"] = _time_ms(lambda: fps._fps_plain(surface, FPS_EVAL_POINTS, vis400),
                                    reps=2, warm=1)
    print(f"  time fps     {fps_eval['shape']}: plain {fps_eval['plain_ms']:.4f} ms")
    timing = {
        "fps": dict(
            **_fps_times(dev, surface, vis, k),
            plain_ms=_time_ms(lambda: fps._fps_plain(surface, k, vis), reps=2, warm=1),
            library_ms=None,
            bound=bound((k - 1) * n_vis * FPS_OPS_PER_POINT, P * (12 + 1) + k * 8),
            shape=f"N={P} ({n_vis} visible) k={k}", max_abs_err=fps_err,
            at_eval_shape=fps_eval),
        "icp_kabsch": dict(
            ms=mlp["ms"], device_ms=mlp["device_ms"], plain_ms=mlp["plain_ms"], library_ms=None,
            bound=bound(B * n * ICP_STEP_OPS_PER_POINT, B * n * ICP_STEP_BYTES_PER_POINT),
            shape=f"B={B} N=M={n}, weights {ICP_MLP_DENSITY:g}", max_abs_err=step_err,
            at_shapes=step_times, skeleton_ms=skeleton_ms),
        "pca_normals": dict(
            ms=_time_ms(lambda: plane.pca_normals(fr, fr_idx)),
            device_ms=_device_ms(lambda: plane.pca_normals(fr, fr_idx)),
            plain_ms=_time_ms(lambda: plane._pca_normals_plain(fr, fr_idx)),
            library_ms=None,
            bound=bound(N * (21 * PCA_K + 770), N * (8 * PCA_K + 12 + 12)),
            shape=f"N={N} k={PCA_K}", max_abs_err=normals_err),
    }
    for name, t in timing.items():
        lib = "none (no one PyTorch call)" if t["library_ms"] is None else \
            f"{t['library_ms']:.4f} ms"
        print(f"  time {name:12s} {t['shape']}: wrapper {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, library {lib}, bound "
              f"{t['bound'][0]:.6f} ms ({t['bound'][1]})")
    return timing


def _update_case(dev, mode: str, hidden: int, S: int, K: int, seed: int = 0):
    """A carry, per-parameter gradients, a loss and poses for the epoch's
    update: random moments and steps, sequences frozen, improving, cut by
    the plateau and stopping."""
    from autourdf_tpu_torch.models.regmlp import PoseRegressor
    from autourdf_tpu_torch.registration import optimizer as opt

    rng = np.random.default_rng(seed)
    t = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a)).to(dev, dtype)
    model = PoseRegressor(mode, hidden, num_seqs=S, generator=torch.Generator().manual_seed(seed),
                          device=dev)
    theta = model.flat_params()
    P = theta.shape[1]
    best = rng.uniform(0.01, 0.02, S)
    carry = opt.TrainCarry(
        theta=theta,
        opt=opt.AdamState(t(1e-3 * rng.normal(size=(S, P))), t(1e-6 * rng.random((S, P))),
                          t(rng.integers(0, 300, S), torch.int32)),
        sched=opt.PlateauState(t(best * rng.uniform(0.99, 1.0, S)),
                               t(rng.integers(0, 6, S), torch.int32),
                               t(2e-4 * 0.7 ** rng.integers(0, 3, S))),
        best_loss=t(best), best_m=t(rng.normal(size=(S, K, 4, 4))),
        bad_count=t(rng.integers(195, 201, S), torch.int32), stopped=t(rng.random(S) < 0.2,
                                                                        torch.bool))
    grads = [t(1e-2 * rng.normal(size=p.shape)) for p in model.unflatten(theta).values()]
    loss = t(best * rng.uniform(0.98, 1.02, S))
    return carry, grads, loss, t(rng.normal(size=(S, K, 4, 4)))


def _assembled(table, S: int, P: int) -> torch.Tensor:
    """The flat gradient as autograd assembles it against the flat theta:
    a zero-filled (S, P) tensor a piece with the piece copied in (its view's
    SliceBackward), added up."""
    total = None
    for g, off in table:
        z = torch.zeros(S, P, device=g.device)
        z[:, off:off + g.shape[1]].copy_(g)
        total = z if total is None else total + z
    return total


def check_epoch_update(dev) -> dict:
    """Phase 3 for csrc/optim.cu: ``epoch_update_kernel`` against the plain
    chain on the card, every field of the carry and the masked loss bit for
    bit, at the main path's shape and at small odd ones, over three epochs
    each; then its time at the main path's shape beside its bound and the
    plain chain's, the flat gradient's assembly included."""
    from autourdf_tpu_torch.ops import _cuda
    from autourdf_tpu_torch.registration import optimizer as opt

    steps = (200, 5, 0.7)
    for mode, hidden, S, K in (("q", UPDATE_HIDDEN, UPDATE_S, UPDATE_K), ("q", 20, 5, 4),
                               ("dq", 21, 3, 7), ("6d", 64, 7, 5)):
        carry, grads, loss, m2 = _update_case(dev, mode, hidden, S, K)
        P = carry.theta.shape[1]
        for epoch in range(3):
            before = _cuda.launch_counts["epoch_update"]
            got = opt.epoch_update(carry, grads, loss, m2, *steps)
            launched = _cuda.launch_counts["epoch_update"] - before
            flat = torch.cat([g.reshape(S, -1) for g in grads], dim=1)
            ref = opt._epoch_update_plain(carry, flat, loss, m2, *steps)
            torch.cuda.synchronize(dev)
            leaves = lambda r: [r[0].theta, *r[0].opt, *r[0].sched, *r[0][3:], r[1]]
            same = [torch.equal(a, b) for a, b in zip(leaves(got), leaves(ref))]
            print(f"  epoch_update {mode} hidden {hidden}: S={S}, P={P}, K={K}, epoch {epoch}: "
                  f"{sum(same)} of {len(same)} fields bit-equal, {launched} launch; "
                  f"frozen {got[0].stopped.tolist()}")
            if launched != 1 or not all(same):
                _fail(f"epoch_update_kernel disagrees with the plain chain ({mode}, {hidden}, "
                      f"epoch {epoch}): fields {same}")
            carry = got[0]
            loss = loss * torch.linspace(0.97, 1.03, S, device=dev)

    carry, grads, loss, m2 = _update_case(dev, "q", UPDATE_HIDDEN, UPDATE_S, UPDATE_K)
    S, P = carry.theta.shape
    table = opt.update_segments(grads, S, P)

    def kernel():
        return opt.epoch_update(carry, grads, loss, m2, *steps)

    def plain():
        return opt._epoch_update_plain(carry, _assembled(table, S, P), loss, m2, *steps)

    def launches(fn) -> int:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(dev)
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)

    nbytes = S * P * UPDATE_BYTES_PER_PARAM
    t = dict(ms=_time_ms(kernel), device_ms=_device_ms(kernel), plain_ms=_time_ms(plain),
             plain_device_ms=_device_ms(plain), library_ms=None,
             bound=(1e3 * nbytes / PEAK_BYTES_PER_S, "bytes"),
             kernels_a_call=launches(kernel), plain_kernels_a_call=launches(plain),
             shape=f"S={S} P={P} K={UPDATE_K}, {len(table)} segments", max_abs_err=0.0)
    print(f"  time epoch_update {t['shape']}: wrapper {t['ms']:.4f} ms (device "
          f"{t['device_ms']:.4f} ms, {t['kernels_a_call']} kernel a call), plain chain with the "
          f"flat gradient's assembly {t['plain_ms']:.4f} ms (device {t['plain_device_ms']:.4f} "
          f"ms, {t['plain_kernels_a_call']} kernels), bound {t['bound'][0]:.6f} ms (bytes: "
          f"{nbytes / 1e6:.1f} MB)")
    return {"epoch_update": t}


# True while a comparison with a plain version may call PyTorch's solvers on
# the card (see _solvers_allowed)
_SOLVERS_OPEN = [False]


def _forbid_cuda_solvers() -> list:
    """Wrap ``torch.linalg.svd``, ``det`` and ``eigh`` so that a call on a
    CUDA tensor is recorded (in the returned list) and raises, but inside
    ``_solvers_allowed``."""
    calls: list = []

    def guard(name, fn):
        def call(*a, **kw):
            if not _SOLVERS_OPEN[0] and any(isinstance(t, torch.Tensor) and t.is_cuda
                                            for t in (*a, *kw.values())):
                calls.append(name)
                raise RuntimeError(f"torch.linalg.{name} on a CUDA tensor")
            return fn(*a, **kw)
        return call

    for name in ("svd", "det", "eigh"):
        setattr(torch.linalg, name, guard(name, getattr(torch.linalg, name)))
    return calls


@contextlib.contextmanager
def _solvers_allowed():
    """The plain versions (``svd``, ``det``, ``eigh``) may run on the card
    in this block: a comparison, not a path."""
    _SOLVERS_OPEN[0] = True
    try:
        yield
    finally:
        _SOLVERS_OPEN[0] = False


def run_main_path(dev, gpu_line: str, root: str) -> dict:
    """Phase 4: the registration path through its public entry point, into
    the data root ``root`` (phase 6 builds the URDF from its artifacts)."""
    from autourdf_tpu_torch.config import PipelineConfig
    from autourdf_tpu_torch.ops import _cuda
    from autourdf_tpu_torch.ops.chamfer import chamfer_distance
    from autourdf_tpu_torch.registration import predicted_world_points
    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.utils import programs

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

    _cuda.reset_launch_counts()
    made = len(programs.captures)
    torch.cuda.synchronize(dev)
    t0 = time.time()
    stats = workflow.run_registration(cfg, seed=0, corr_every=1, device=dev)
    result = stats.pop("result")
    with torch.no_grad():
        last = predicted_world_points(result, T - 1)
        resid = chamfer_distance(last, ft[:, -1], mt[:, -1], mt[:, -1])
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    counts = dict(_cuda.launch_counts)

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
    print(f"  launches: {counts}; the registration's programs (CUDA graphs, captured in it):")
    _print_captures(programs.captures[made:])
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
    if counts["epoch_update"] != PAIRS * 2 * EPOCHS:
        _fail(f"epoch_update launched {counts['epoch_update']} times, expected "
              f"{PAIRS * 2 * EPOCHS} (one an epoch)")
    return {"counts": counts, "n": N, "stats": stats, "cfg": cfg}


@contextlib.contextmanager
def _launch_shapes(shapes: collections.Counter):
    """Count the launches of the search kernels made on the host inside the
    block by (kernel, S, N, M, norm): the eager calls and the warm-ups and
    captures of programs, not their replays (``_cuda.launch_counts`` has
    those)."""
    from autourdf_tpu_torch.ops import knn

    launch = knn._launch_sweep

    def recording(x, y, norm, plan):
        shapes[(plan.kernel, x.shape[0], x.shape[1], y.shape[1], norm)] += 1
        return launch(x, y, norm, plan)

    knn._launch_sweep = recording
    try:
        yield shapes
    finally:
        knn._launch_sweep = launch


def _check_urdf(out: dict, label: str) -> np.ndarray:
    """The URDF of a build: ``links - 1`` joints with finite unit axes and a
    non-empty mesh a link; returns the axes."""
    robot = ET.parse(out["urdf_path"]).getroot()
    links, joints = robot.findall("link"), robot.findall("joint")
    stls = [m.get("filename") for m in robot.iter("mesh")]
    axes = np.array([[float(v) for v in j.find("axis").get("xyz").split()] for j in joints])
    if len(links) != out["num_links"] or len(joints) != out["num_links"] - 1:
        _fail(f"URDF has {len(links)} links and {len(joints)} joints for "
              f"{out['num_links']} links ({label})")
    if out["num_links"] < 2:
        _fail(f"no articulation found ({label})")
    bad = [f for f in stls if not (os.path.exists(f) and os.path.getsize(f) > 84)]
    if bad or len(set(stls)) != out["num_links"]:
        _fail(f"missing or empty meshes: {bad[:3]} ({label})")
    if not np.all(np.isfinite(axes)) or not np.allclose(np.linalg.norm(axes, axis=1), 1.0,
                                                         atol=1e-6):
        _fail(f"a joint axis is not a finite unit vector ({label}): {axes.tolist()}")
    return axes


def run_urdf_stage(dev, cfg) -> tuple[dict, dict]:
    """Phase 6 (Path B): structure -> joints -> meshes -> URDF from the
    artifacts of phase 4, with the known DoF and with the DoF search.
    Returns the path's counts and the known-DoF build's output ([16] fits
    its joints)."""
    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    builds = {}
    for label, kw in (("known DoF", dict(unknown_dof=False)),
                      ("unknown DoF, no probe", dict(unknown_dof=True, dof_probe=False))):
        before = _cuda.launch_counts["nn"]
        shapes: collections.Counter = collections.Counter()
        t0 = time.time()
        with _launch_shapes(shapes):        # the shapes this build launches
            out = builds[label] = workflow.run_build_urdf(cfg, refine="none", tree="mst",
                                                          end_video=5, verbose=False, device=dev,
                                                          **kw)
        torch.cuda.synchronize(dev)
        seconds = time.time() - t0
        launched = _cuda.launch_counts["nn"] - before
        print(f"  {label}: host launches (programs' warm-ups and captures, not their replays) "
              f"by (kernel, S, N, M, norm): {dict(shapes.most_common())}")
        axes = _check_urdf(out, label)
        print(f"  {label}: {out['num_links']} links, dof {out['dof']}, {len(axes)} joints, "
              f"{seconds:.3f} s, nn launches {launched}")
        if launched < 1:
            _fail(f"the urdf stage did not go through the nn kernel ({label})")
    return {"counts": dict(_cuda.launch_counts)}, builds["known DoF"]


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
    first 2 sequences x 4 frames of the real scans, at full width; the ICP
    phase and the normals resample run as programs."""
    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.config import PipelineConfig
    from autourdf_tpu_torch.ops import _cuda
    from autourdf_tpu_torch.utils import programs

    S, T = 2, 4
    _real_scan_subset(root, S, T)
    cfg = PipelineConfig(robot="wx200_real_5", data_root=root, rot="q", epochs=EPOCHS,
                         num_videos=S, seed_mode="fps")
    _, frames, masks = workflow.load_raw_sequences_padded(cfg.raw_dir(), S)
    raw_mean = _raw_chamfer(dev, frames, masks)
    _cuda.reset_launch_counts()
    made = len(programs.captures)
    stats = workflow.run_registration(cfg, seed=0, mlp_icp=True, use_normals=True, device=dev)
    torch.cuda.synchronize(dev)
    counts = dict(_cuda.launch_counts)
    result = stats.pop("result")
    print(f"  {frames.shape[0]} sequences x {frames.shape[1]} frames x {frames.shape[2]} points, "
          f"K={cfg.num_segments()}, hidden 512, {EPOCHS} epochs, mlp_icp, normals, FPS seeds: "
          f"{stats['seconds']:.3f} s; mean raw Chamfer {raw_mean:.6f}, mean loss "
          f"{stats['mean_loss']:.6f}")
    print(f"  launches: {counts} (ICP: {T - 1} pairs x {ICP_ITERATIONS} iterations, one launch "
          f"of nn and one of icp_kabsch for the whole batch of {S} x {cfg.num_segments()} "
          f"clusters; normals: the segmentation's frame, then each pair's {S} targets; FPS "
          f"seeds: one pick); the registration's programs:")
    _print_captures(programs.captures[made:])
    if frames.shape[:2] != (S, T):
        _fail(f"expected {S} sequences x {T} frames, got {frames.shape[:2]}")
    expected = {"nn": (T - 1) * ICP_ITERATIONS, "icp_kabsch": (T - 1) * ICP_ITERATIONS,
                "pca_normals": 1 + (T - 1) * S, "fps": 1}
    for k, n in expected.items():
        if counts[k] != n:
            _fail(f"{k} launched {counts[k]} times, expected {n}")
    if not any(r["name"] == "icp_phase" for r in programs.captures[made:]) or \
            not any(r["name"] == "resample" for r in programs.captures[made:]):
        _fail("the ICP phase and the normals resample did not run as programs")
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
    from autourdf_tpu_torch.ops import _cuda

    T = 3
    cfg = PipelineConfig(robot="wx200_5", data_root=root, rot="q", epochs=EPOCHS, num_videos=1)
    frames = articulated_chain_frames(T, LARGE_N)
    for t in range(T):
        write_ply(os.path.join(cfg.raw_dir(), "V0000", f"{t:04}", "robot.ply"), frames[t])
    raw_mean = _raw_chamfer(dev, frames[None], None)
    _cuda.reset_launch_counts()
    stats = workflow.run_registration(cfg, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    counts = dict(_cuda.launch_counts)
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


def _wall_busy(dev, fn, units: int, reps: int = 2):
    """Wall ms a unit (an epoch, a step) of ``fn`` over ``reps`` calls after
    one warm call (a program's capture), then the device's busy ms a unit
    and its kernels (torch.profiler over one more call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    t0 = time.time()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(dev)
    wall_ms = 1e3 * (time.time() - t0) / (reps * units)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3 / units, e.count / units)
            for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall_ms, sum(r[1] for r in rows), rows


def profile_epochs(dev, n: int) -> dict:
    """Phase 4b: where one training epoch's time goes at the main path's
    shape (5 sequences, K=20, hidden 512, n points), eager (20-epoch loops)
    and graphed (a 300-epoch phase of three 100-epoch chunk programs): wall
    ms an epoch, the device's busy ms an epoch, the idle share and the top
    kernels (torch.profiler)."""
    from autourdf_tpu_torch.models.regmlp import PoseRegressor
    from autourdf_tpu_torch.registration.optimizer import train_epochs, train_init, train_pose_mlp

    S, K = 5, 20
    rng = np.random.default_rng(2)
    model = PoseRegressor("q", 512, num_seqs=S, generator=torch.Generator().manual_seed(0),
                          device=dev)
    mats = torch.eye(4, device=dev).repeat(S, K, 1, 1)
    mats[..., :3, 3] = torch.from_numpy(rng.uniform(-0.2, 0.2, (S, K, 3))).float().to(dev)
    pts = torch.from_numpy(rng.normal(scale=0.03, size=(S, n, 3))).float().to(dev)
    labels = torch.from_numpy(rng.integers(0, K, (S, n))).to(dev)
    target = torch.from_numpy(rng.uniform(-0.2, 0.2, (S, n, 3))).float().to(dev)

    def eager(k=20):
        carry = train_init(model.flat_params(), mats, 2e-4)
        train_epochs(model, carry, mats, target, pts, labels, k)

    def graphed():
        train_pose_mlp(model, model.flat_params(), mats, target, pts, labels, epochs=EPOCHS,
                       dispatch_epochs=100)

    out = {}
    for name, fn, units in (("eager", eager, 20), ("graphed", graphed, EPOCHS)):
        wall_ms, busy, rows = _wall_busy(dev, fn, units)
        out[name] = dict(wall_ms=wall_ms, busy_ms=busy, idle=1 - busy / wall_ms)
        print(f"  {name} epoch (S={S}, N={n}, K={K}, hidden 512): wall {wall_ms:.3f} ms, device "
              f"busy {busy:.3f} ms, device idle share {1 - busy / wall_ms:.3f}, "
              f"{sum(r[2] for r in rows):.1f} device kernels")
        for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:6]:
            print(f"    {ms:.4f} ms x{cnt:.1f}  {key[:90]}")
    if not out["graphed"]["busy_ms"] > 0:
        _fail("the profiler saw no device work in the graphed epochs")
    return out


# the entry points that run chain fits, each with the label its fits get
_FIT_ENTRIES = (("autourdf_tpu_torch.joints.chain", "refine_chain_multi_anchor", "veto loop"),
                ("autourdf_tpu_torch.workflow", "_select_tree_by_chain_fit", "tree arbitration"),
                ("autourdf_tpu_torch.structure", "probe_k_selection", "probe ladder"))


@contextlib.contextmanager
def _chain_fits(fits: list):
    """Record every chain fit inside the block: the entry point it ran under
    (``kind``: the veto loop's refine_chain_multi_anchor, the tree
    arbitration, the probe ladder), its steps and model points, wall
    seconds, first and last loss, freeze deltas and subtree shares."""
    from autourdf_tpu_torch.joints import chain

    active: list = []
    patched = []

    def labelled(fn, kind):
        def call(*a, **k):
            active.append(kind)
            try:
                return fn(*a, **k)
            finally:
                active.pop()
        return call

    inner = chain.refine_chain

    def recording(*a, **k):
        t0 = time.time()
        refined, res = inner(*a, **k)
        losses = res.step_losses
        fits.append(dict(kind=active[-1] if active else "direct", steps=len(losses),
                         points=k.get("points_per_link", 768), seconds=time.time() - t0,
                         first=float(losses[0]) if len(losses) else None, last=res.loss,
                         freeze=res.freeze_deltas, share=res.subtree_share,
                         joints=len(refined)))
        return refined, res

    for mod_name, attr, kind in _FIT_ENTRIES:
        mod = importlib.import_module(mod_name)
        patched.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, labelled(getattr(mod, attr), kind))
    chain.refine_chain = recording
    try:
        yield fits
    finally:
        chain.refine_chain = inner
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)


def run_default_urdf(dev, cfg) -> tuple[dict, dict]:
    """Phase 9: workflow.run_build_urdf with the JAX package's defaults
    (refine="chain" with 1,200 steps and the fit -> veto -> prune -> refit
    loop, tree="motion" arbitrated against the MST, the probe ladder with
    the unknown DoF) on the artifacts of phase 4, known DoF then unknown.
    Returns the path's counts and the builds' outputs by label."""
    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    outs = {}
    for label, kw in (("known DoF", dict(unknown_dof=False)),
                      ("unknown DoF, probe ladder", dict(unknown_dof=True))):
        shapes: collections.Counter = collections.Counter()
        fits: list = []
        before = dict(_cuda.launch_counts)
        torch.cuda.synchronize(dev)
        t0 = time.time()
        with _launch_shapes(shapes), _chain_fits(fits):
            out = workflow.run_build_urdf(cfg, end_video=5, verbose=False, device=dev, **kw)
        torch.cuda.synchronize(dev)
        seconds = time.time() - t0
        outs[label] = out
        launched = {k: _cuda.launch_counts[k] - before[k] for k in _cuda.launch_counts}
        axes = _check_urdf(out, label)
        print(f"  {label}: {seconds:.3f} s wall; {out['num_links']} links, dof {out['dof']}, "
              f"{len(axes)} joints; launches {launched}")
        by_kind: dict = {}
        for f in fits:
            k = by_kind.setdefault(f["kind"], dict(fits=0, steps=0, seconds=0.0))
            k["fits"] += 1
            k["steps"] += f["steps"]
            k["seconds"] += f["seconds"]
        for kind, k in by_kind.items():
            print(f"    {kind}: {k['fits']} fits, {k['steps']} steps, {k['seconds']:.3f} s, "
                  f"{1e3 * k['seconds'] / max(k['steps'], 1):.3f} ms a step (set-up included)")
        vetoes = [f for f in fits if f["kind"] == "veto loop"]
        print(f"    veto passes: {len(vetoes)}; per pass (steps, joints, first loss, last loss): "
              f"{[(f['steps'], f['joints'], round(f['first'], 6), round(f['last'], 6)) for f in vetoes]}")
        last = vetoes[-1]
        print(f"    last pass: freeze deltas {np.round(last['freeze'], 4).tolist()}, "
              f"subtree shares {np.round(last['share'], 4).tolist()}, normalised "
              f"{np.round(last['freeze'] / np.maximum(last['share'], 1e-6), 3).tolist()}")
        print(f"    host launches (programs' warm-ups and captures, not their replays) by "
              f"(kernel, S, N, M, norm): {dict(shapes.most_common(12))}"
              + (f" and {len(shapes) - 12} more shapes" if len(shapes) > 12 else ""))
        if not vetoes or not all(f["last"] < f["first"] for f in vetoes):
            _fail(f"a chain fit did not lower its loss ({label})")
        if any(f["steps"] != 1200 for f in vetoes):
            _fail(f"the default chain fit ran {[f['steps'] for f in vetoes]} steps ({label})")
        if kw["unknown_dof"] and not any(f["kind"] == "probe ladder" for f in fits):
            _fail("the unknown-DoF build did not run the probe ladder")
        for k in ("nn_bidir_acc", "nn_min_bidir", "nn"):
            if launched[k] < 1:
                _fail(f"the default urdf stage did not launch {k} ({label})")
    return {"counts": dict(_cuda.launch_counts)}, outs


@contextlib.contextmanager
def _step_loop_clock(dev, marks: list):
    """Record (after a synchronise) the time at which a chain fit's step loop
    starts: the first eager step or the first chunk program's call, so that a
    fit's set-up on the host stays out of its per-step time."""
    from autourdf_tpu_torch.joints import chain
    from autourdf_tpu_torch.utils import programs

    def first(fn):
        def call(*a, **k):
            if not marks:
                torch.cuda.synchronize(dev)
                marks.append(time.time())
            return fn(*a, **k)
        return call

    step, run = chain._chain_step, programs.run
    chain._chain_step, programs.run = first(step), first(run)
    try:
        yield marks
    finally:
        chain._chain_step, programs.run = step, run


def profile_chain_steps(dev, cfg, out: dict) -> dict:
    """Phase 9b: where a chain-fit step's time goes, on a build's final links
    and joints, eager and graphed (chunk programs of 50 steps): wall ms a
    step from the start of the step loop to the end of a 120-step fit (the
    mean of two fits after a warm one, which captures the programs), the
    device's busy ms a step (torch.profiler: the difference of 120- and
    20-step fits), the idle share, the search kernels' share and the top
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.joints.chain import refine_chain

    cms, _ = workflow.build_coord_maps(cfg, 5, cfg.start_steps, cfg.end_steps)
    frames, fmasks = workflow._load_refine_frames(cfg, 5)
    S, T, N = frames.shape[:3]
    res = {}
    for name in ("eager", "graphed"):
        def fit(steps):
            refine_chain(out["links"], out["joints"], cms, frames, steps=steps,
                         points_per_link=1024, frame_masks=fmasks, freeze_probe=False,
                         device=dev, eager=name == "eager")
            torch.cuda.synchronize(dev)

        fit(120)                     # captures the 50- and 20-step programs
        loops = []
        for _ in range(2):
            with _step_loop_clock(dev, []) as marks:
                fit(120)
            loops.append(time.time() - marks[0])
        wall_ms = 1e3 * sum(loops) / (2 * 120)
        busy = {}
        for steps in (20, 120):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fit(steps)
            busy[steps] = {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3
                           for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA}
        per_step = {k: (busy[120].get(k, 0.0) - busy[20].get(k, 0.0)) / 100 for k in busy[120]}
        busy_ms = sum(per_step.values())
        search = sum(v for k, v in per_step.items() if "nn_" in k and "_kernel" in k)
        res[name] = dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=1 - busy_ms / wall_ms)
        print(f"  {name} chain step (S*T={S * T}, {len(out['links'])} links x 1024 points, "
              f"frames of {N} points): wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
              f"device idle share {1 - busy_ms / wall_ms:.3f}, search kernels {search:.3f} ms "
              f"({search / max(busy_ms, 1e-9):.3f} of busy)")
        for key, ms in sorted(per_step.items(), key=lambda kv: -kv[1])[:5]:
            print(f"    {ms:.4f} ms a step  {key[:90]}")
        if not (wall_ms > 0 and busy_ms > 0):
            _fail(f"no {name} chain-step time measured")
    return res


def run_chain_options(dev, cfg) -> dict:
    """Phase 10: the opt-in chain options once, 100 steps: chain_anchors=2,
    canonical_frames=3 (the ICP polish of the canonical union), chain_trunc=2.0
    (the truncated Chamfer)."""
    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    fits: list = []
    torch.cuda.synchronize(dev)
    t0 = time.time()
    with _chain_fits(fits):
        out = workflow.run_build_urdf(cfg, unknown_dof=False, refine_steps=100, chain_anchors=2,
                                      canonical_frames=3, chain_trunc=2.0, end_video=5,
                                      verbose=False, device=dev)
    torch.cuda.synchronize(dev)
    counts = dict(_cuda.launch_counts)
    axes = _check_urdf(out, "chain options")
    fit_steps = [(f["kind"], f["steps"]) for f in fits]
    print(f"  {time.time() - t0:.3f} s wall; {out['num_links']} links, {len(axes)} joints; fits "
          f"{fit_steps}; launches {counts}")
    anchored = [f for f in fits if f["kind"] == "veto loop"]
    if len(anchored) < 2 or not all(f["last"] < f["first"] for f in anchored):
        _fail(f"the anchored fits did not run or did not lower their loss: {fit_steps}")
    if counts["nn_bidir_acc"] < 1 or counts["nn"] < 1:
        _fail(f"the chain options did not launch the search kernels: {counts}")
    return {"counts": counts}


def _real_scan_subset(root: str, sequences: int, frames: int) -> None:
    """Link the first ``sequences`` x ``frames`` of the tracked real scans into
    the flat real-scan layout under the data root ``root``."""
    src = os.path.join(REPO, "data_real", "raw", "wx200_real_5")
    for seq in sorted(os.listdir(src))[:sequences]:
        os.makedirs(os.path.join(root, "raw", "wx200_real_5", seq))
        for frame in sorted(os.listdir(os.path.join(src, seq)))[:frames]:
            os.symlink(os.path.join(src, seq, frame),
                       os.path.join(root, "raw", "wx200_real_5", seq, frame))


def register_real_scans_twice(dev, root: str, sequences: int = 2, frames: int = 4):
    """Register the first ``sequences`` x ``frames`` of the real scans twice
    at seed 0, at full width, each run into its own data root under
    ``root``: ``(max |matrix a - b|, labels that differ, max |loss a - b|,
    the two runs' seconds)``.  ``tests/test_torch_cuda.py`` calls it too."""
    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.config import PipelineConfig

    runs, seconds = [], []
    for run in ("a", "b"):
        data_root = os.path.join(root, run)
        _real_scan_subset(data_root, sequences, frames)
        cfg = PipelineConfig(robot="wx200_real_5", data_root=data_root, rot="q", epochs=EPOCHS,
                             num_videos=sequences)
        stats = workflow.run_registration(cfg, seed=0, verbose=False, device=dev)
        runs.append(stats["result"])
        seconds.append(stats["seconds"])
    a, b = runs
    return (float((a.matrices - b.matrices).abs().max()), int((a.labels != b.labels).sum()),
            float((a.losses - b.losses).abs().max()), seconds)


def run_reproducibility(dev, root: str) -> None:
    """Phase 4c: two registrations of the first 2 sequences x 4 frames of the
    real scans at seed 0 must give equal matrices, labels and losses, bit
    for bit."""
    mat, labels, loss, seconds = register_real_scans_twice(dev, root)
    print(f"  2 sequences x 4 frames, K=20, hidden 512, {EPOCHS} epochs, seed 0, twice "
          f"({seconds[0]:.3f} s, {seconds[1]:.3f} s): max |matrix a - b| {mat}, labels that "
          f"differ {labels}, max |loss a - b| {loss}")
    if (mat, labels, loss) != (0.0, 0, 0.0):
        _fail("two registrations of the same scans at the same seed differ")


@contextlib.contextmanager
def _timed_stages(stages: dict):
    """Record each workflow stage's wall time (device synchronised) and its
    return value, by stage function name, while the block runs."""
    from autourdf_tpu_torch import workflow

    names = ("run_dataset", "run_registration", "run_build_urdf", "run_evaluation")
    originals = {n: getattr(workflow, n) for n in names}

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stages[name] = (time.time() - t0, out)
            return out
        return call

    for n, fn in originals.items():
        setattr(workflow, n, timed(n, fn))
    try:
        yield stages
    finally:
        for n, fn in originals.items():
            setattr(workflow, n, fn)


def time_capture(dev, gt: str) -> None:
    """One capture of the closed loop's dataset (20 cameras at 800 x 800 px,
    200,000 surface points, 5,000 picked, the noise on) and one of its
    evaluation (400 x 400 px, 10,000 picked), each with the share of its
    farthest-point pick (one launch of fps_kernel under the visibility mask,
    as the capture makes it); medians of 3 after a warm-up."""
    from autourdf_tpu_torch.ops import _cuda
    from autourdf_tpu_torch.ops.fps import farthest_point_sample
    from autourdf_tpu_torch.sim import KinematicEnv
    from autourdf_tpu_torch.sim.capture import visible_mask

    env = KinematicEnv.create(gt, dof=5, radius=1.5, num_cameras=20,
                              camera_rng=np.random.default_rng(0), device=dev)
    env.set_joint_positions(np.array([0.3, -0.2, 0.4, 0.1, -0.3]))
    pts = torch.from_numpy(env.posed_surface_points()).to(dev)

    def wall(fn, reps=3):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            times.append(time.time() - t0)
        return statistics.median(times)

    for pix, k, noise in ((800, CLOSED_LOOP_POINTS, (0.01, 0.0005)), (400, 10000, (0.0, 0.0))):
        gen = torch.Generator(device=dev).manual_seed(0)
        whole = wall(lambda: env.capture(gen, num_points=k, width=pix, height=pix,
                                         pose_noise=noise[0], point_noise=noise[1]))
        vis = visible_mask(pts, env.rig, pix, pix).any(0)
        before = _cuda.launch_counts["fps"]
        fps = wall(lambda: farthest_point_sample(pts, k, vis))
        launches = (_cuda.launch_counts["fps"] - before) // 4
        splat = wall(lambda: visible_mask(pts, env.rig, pix, pix))
        print(f"  one capture, 20 cameras at {pix} x {pix} px, {len(pts)} surface points "
              f"({int(vis.sum())} visible), {k} picked: {1e3 * whole:.3f} ms wall; projection, "
              f"splat and visibility {1e3 * splat:.3f} ms; farthest-point pick {1e3 * fps:.3f} ms "
              f"in {launches} launch of fps_kernel ({fps / whole:.3f} of the capture, "
              f"{1e3 * fps / k:.4f} ms a step)")


def time_native_meshing() -> None:
    """marching_tetrahedra on a 120^3 ball through the native library and
    through the numpy extractor (median of 3 each)."""
    from autourdf_tpu_torch.io import native
    from autourdf_tpu_torch.mesh import marching_tetrahedra

    g = np.indices((120, 120, 120)).transpose(1, 2, 3, 0) - 59.5
    ball = (g ** 2).sum(-1) <= 55.0 ** 2
    times = {}
    available = native.available
    for label, avail in (("native", available), ("numpy", lambda: False)):
        native.available = avail
        try:
            runs = []
            for _ in range(3):
                t0 = time.time()
                mesh = marching_tetrahedra(ball, 0.003)
                runs.append(time.time() - t0)
        finally:
            native.available = available
        times[label] = (statistics.median(runs), len(mesh.faces))
    print(f"  marching tetrahedra on a 120^3 ball: native {1e3 * times['native'][0]:.3f} ms "
          f"({times['native'][1]} faces), numpy {1e3 * times['numpy'][0]:.3f} ms "
          f"({times['numpy'][1]} faces)")
    if times["native"][1] != times["numpy"][1]:
        _fail("the native and the numpy extractor give different surfaces")


def run_closed_loop(dev, root: str) -> dict:
    """Phase 11: ``python -m autourdf_tpu_torch.cli all`` at the JAX CLI's
    defaults on the tracked wx200 estimate (5 sequences x 10 frames simulated
    with 20 cameras at 800 px, 5,000 points a frame from 200,000 surface
    points; registration K=20, hidden 512, mode q, 300 epochs; the default
    urdf build with the unknown DoF; evaluation at 3 configurations plus the
    gt-vs-gt floor).  Checks the dataset, the registration against the raw
    Chamfer, the URDF, the scores, the telemetry and the kernels' launches."""
    from autourdf_tpu_torch import cli
    from autourdf_tpu_torch.io import native
    from autourdf_tpu_torch.io.ply import read_ply
    from autourdf_tpu_torch.ops import _cuda

    if not native.available():
        _fail(f"the native host library did not build: {native.build_log[-2000:]}")
    gt = os.path.join(REPO, WX200_ESTIMATE)
    params = os.path.join(root, "parameters.json")
    with open(params, "w") as f:
        json.dump({"wx200_5_ab5": {"gt": gt, "num_seg": 20, "dof": 5, "voxel_size": 0.003,
                                   "cam_dist": 1.5, "ori": [0, 0, 0], "sim_ori": [0, 0, 0]}}, f)
    stages: dict = {}
    log = os.path.join(root, "cli_all.log")
    _cuda.reset_launch_counts()
    torch.cuda.synchronize(dev)
    t0 = time.time()
    with _timed_stages(stages), open(log, "w") as f, contextlib.redirect_stdout(f):
        rc = cli.main(["all", "--parameters-json", params, "--robot", "wx200_5_ab5",
                       "--data-root", root])
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    counts = dict(_cuda.launch_counts)
    with open(log) as f:
        lines = f.read().splitlines()
    print(f"  cli all: exit {rc}, {wall:.3f} s wall; {len(lines)} lines of output, the last:")
    for ln in lines[-6:]:
        print(f"    {ln[:300]}")
    if rc != 0:
        _fail(f"cli all exited {rc}")
    for name in ("run_dataset", "run_registration", "run_build_urdf", "run_evaluation"):
        print(f"  {name}: {stages[name][0]:.3f} s")

    seq_dirs = stages["run_dataset"][1]
    tried = 1 + max(int(os.path.basename(d)[1:]) for d in seq_dirs) if seq_dirs else 0
    print(f"  dataset: {len(seq_dirs)} sequences kept of {tried} tried "
          f"({tried - len(seq_dirs)} collided and were retried)")
    if len(seq_dirs) != CLOSED_LOOP_SEQS:
        _fail(f"expected {CLOSED_LOOP_SEQS} sequences, got {len(seq_dirs)}")
    frames = []
    for d in seq_dirs:
        seq = []
        for t in range(CLOSED_LOOP_FRAMES):
            fd = os.path.join(d, f"{t:04}")
            if not os.path.exists(os.path.join(fd, "joint_cfg.txt")):
                _fail(f"missing {fd}/joint_cfg.txt")
            seq.append(read_ply(os.path.join(fd, "robot.ply")))
        frames.append(np.stack(seq))
    frames = np.stack(frames)
    if frames.shape != (CLOSED_LOOP_SEQS, CLOSED_LOOP_FRAMES, CLOSED_LOOP_POINTS, 3) or \
            not np.isfinite(frames).all():
        _fail(f"dataset frames {frames.shape}, finite {np.isfinite(frames).all()}")

    reg = stages["run_registration"][1]
    raw_mean = _raw_chamfer(dev, frames, None)
    print(f"  registration: {reg['seconds']:.3f} s, {reg['frames_per_second']:.4f} frames/s; "
          f"mean raw Chamfer {raw_mean:.6f}, mean step-phase loss {reg['mean_step_loss']:.6f}, "
          f"mean anchor-phase loss {reg['mean_loss']:.6f}")
    if not reg["mean_loss"] < raw_mean:
        _fail(f"mean registration loss {reg['mean_loss']} not below raw Chamfer {raw_mean}")

    out = stages["run_build_urdf"][1]
    axes = _check_urdf(out, "closed loop")
    print(f"  urdf: {out['num_links']} links, dof {out['dof']}, {len(axes)} joints")

    ev = stages["run_evaluation"][1]
    print(f"  evaluation: matched {ev['matched']} / {ev['total']}, pos err "
          f"{np.round(ev['pos_errors'], 5).tolist()} m, dir err "
          f"{np.round(ev['dir_errors'], 3).tolist()} deg (complete {ev['dir_mean_complete']:.3f} "
          f"deg); resim Chamfer {np.round(ev['chamfer_losses'], 6).tolist()} (mean "
          f"{ev['chamfer_mean']:.6f}), floor {ev['chamfer_floor']:.6f}")
    scores = list(ev["pos_errors"]) + list(ev["dir_errors"]) + list(ev["chamfer_losses"])
    if ev["matched"] < 1 or not np.all(np.isfinite(scores + [ev["chamfer_floor"]])):
        _fail("the evaluation gave no finite joint error, resim Chamfer or floor")

    with open(os.path.join(root, "telemetry.json")) as f:
        records = json.load(f)
    print(f"  telemetry: {[{k: v for k, v in r.items() if k != 'start'} for r in records]}")
    if [r["stage"] for r in records] != ["dataset", "register", "build_urdf", "evaluate"]:
        _fail(f"telemetry records {[r['stage'] for r in records]}")
    print(f"  launches: {counts}")
    for k in ("nn_bidir", "nn_bidir_acc", "nn_min_bidir", "nn", "fps", "icp_kabsch"):
        if counts[k] < 1:
            _fail(f"the closed loop did not launch {k}")
    # a capture a frame of each sequence kept or tried, the evaluation's two a
    # configuration and the floor's
    if counts["fps"] < CLOSED_LOOP_SEQS * CLOSED_LOOP_FRAMES:
        _fail(f"fps_kernel launched {counts['fps']} times for "
              f"{CLOSED_LOOP_SEQS * CLOSED_LOOP_FRAMES} captured frames")
    time_capture(dev, gt)
    time_native_meshing()
    return {"counts": counts, "seconds": wall, "frames": frames, "root": root,
            "urdf": out["urdf_path"]}

# ---------------------------------------------------------------------------
# Phases 12 and 13: the parallel layer and the views

# [12a]: the sharded Chamfer's cases, (N, M, masked): the top of the JAX
# package's own shard sweep (dense scans), then sizes no split divides, with
# bool masks
SHARD_CASES = ((131072, 131072, False), (100003, 131071, True))
AUTO_SHARD_M = 40000
# [12c] and [12d]: four of [11]'s sequences at full width
PAR_SEQS, PAR_FRAMES, PAR_K, PAR_HIDDEN, PAR_LR = 4, 3, 20, 512, 2e-4
# [12d]'s losses against the single-process registration (the JAX package's
# tolerance for its sharded registration, tests/test_parallel_native_viz.py)
REG_ATOL = 1e-5


def _counted(fn):
    """``(result, wall s, launch counts)`` of one call, device synchronised,
    the kernels' counts set to 0 just before it."""
    from autourdf_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0, dict(_cuda.launch_counts)


def _shard_case(c: dict, dev):
    x = torch.from_numpy(c["x"]).to(dev).requires_grad_(True)
    y = torch.from_numpy(c["y"]).to(dev).requires_grad_(True)
    xm = None if c["xm"] is None else torch.from_numpy(c["xm"]).to(dev)
    ym = None if c["ym"] is None else torch.from_numpy(c["ym"]).to(dev)
    return x, y, xm, ym


def _masked_copy(x, m):
    from autourdf_tpu_torch.ops.knn import PAD_COORD

    return x.detach() if m is None else torch.where(m[:, None], x.detach(), PAD_COORD)


def rank_sp2_dp2(cases: list, reg: dict) -> dict:
    """[12a], [12b] and [12d] in each of two ranks on the one card: mesh (2,)
    "sp" for the sharded Chamfer and its auto-shard, mesh (2,) "dp" for the
    registration.  Returns what the parent checks, the wall times and the
    launch counts of the counted calls."""
    import autourdf_tpu_torch.parallel.sharding as sh
    from autourdf_tpu_torch.models.regmlp import PoseRegressor
    from autourdf_tpu_torch.ops import chamfer
    from autourdf_tpu_torch.registration import (RegistrationConfig, SegmentInit,
                                                 predicted_world_points)

    mesh = sh.make_mesh((2,), ("sp",))
    dev = mesh.device
    out = {"cases": [], "counts": collections.Counter()}
    for c in cases:
        x, y, xm, ym = _shard_case(c, dev)
        sh.sharded_chamfer(mesh, x, y, xm, ym).backward()        # warm-up
        x.grad = y.grad = None

        def step():
            loss = sh.sharded_chamfer(mesh, x, y, xm, ym)
            loss.backward()
            return loss.detach()

        loss, wall, counts = _counted(step)
        out["counts"].update(counts)
        _, idx, _, _ = sh.sharded_search(mesh, _masked_copy(x, xm)[None],
                                         _masked_copy(y, ym)[None])
        out["cases"].append({"loss": loss, "gx": x.grad, "gy": y.grad, "idx": idx[0],
                             "wall": wall, "counts": counts})

    # [12b]: chamfer_distance dispatches by itself inside the scope
    calls = []
    orig = sh.sharded_chamfer

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    sh.sharded_chamfer = spy
    try:
        x = torch.from_numpy(reg["auto_x"]).to(dev)
        y = torch.from_numpy(reg["auto_y"]).to(dev)
        with sh.mesh_scope(mesh):
            auto = chamfer.chamfer_distance(x, y)
        out["auto"] = {"loss": auto, "calls": len(calls), "threshold": chamfer.AUTO_SHARD_MIN_M}
    finally:
        sh.sharded_chamfer = orig

    # [12d]: the dp registration, then the forward-only Chamfer of its last
    # registered frame against the raw one
    dp = sh.make_mesh((2,), ("dp",))
    model = PoseRegressor("q", PAR_HIDDEN, num_seqs=PAR_SEQS, device=dev)
    cfg = RegistrationConfig(num_seg=PAR_K, hidden_dim=PAR_HIDDEN, epochs=EPOCHS)
    init = SegmentInit(*(torch.from_numpy(a).to(dev) for a in reg["init"]))
    to_t = lambda p: {k: torch.from_numpy(v).to(dev) for k, v in p.items()}
    frames = torch.from_numpy(reg["frames"]).to(dev)

    def register():
        res = sh.register_sequences_sharded(dp, model, cfg, to_t(reg["step"]),
                                            to_t(reg["anchor"]), init, frames)
        with torch.no_grad():
            resid = chamfer.chamfer_distance(predicted_world_points(res, PAR_FRAMES - 1),
                                             frames[:, -1])
        return res, resid

    (res, resid), wall, counts = _counted(register)
    out["counts"].update(counts)
    out["reg"] = {"result": res, "resid": resid, "wall": wall, "counts": counts}
    out["counts"] = dict(out["counts"])
    return out


def rank_dp_sp(step: dict) -> dict:
    """[12c] in each of four ranks on the one card: ``train_step_dp_sp`` on
    mesh (2, 2) ("dp", "sp"), as programs (A, the two all-reduces, B a
    epoch; the first call captures, the second replays only) and eagerly,
    from the same inputs.  Counts the program calls and the sp all-reduces
    of each run, and returns the rank's captures."""
    import autourdf_tpu_torch.parallel.sharding as sh
    from autourdf_tpu_torch.models.regmlp import PoseRegressor
    from autourdf_tpu_torch.utils import programs

    mesh = sh.make_mesh((2, 2), ("dp", "sp"))
    dev = mesh.device
    model = PoseRegressor("q", PAR_HIDDEN, num_seqs=PAR_SEQS, device=dev)
    t = {k: torch.from_numpy(step[k]).to(dev) for k in ("mats", "targets", "points", "labels")}
    params = {k: torch.from_numpy(v).to(dev) for k, v in step["params"].items()}
    calls: collections.Counter = collections.Counter()
    run, reduce = programs.run, sh.all_reduce

    def counting_run(key, *a, **kw):
        calls["program calls"] += 1
        return run(key, *a, **kw)

    def counting_reduce(m, axis, *a, **kw):
        calls[f"all-reduces over {axis}"] += 1
        return reduce(m, axis, *a, **kw)

    programs.run, sh.all_reduce = counting_run, counting_reduce
    out = {}
    try:
        for name in ("programs", "replayed", "eager"):
            calls.clear()
            (best_m, best_l), wall, counts = _counted(lambda: sh.train_step_dp_sp(
                mesh, model, params, t["mats"], t["targets"], t["points"], t["labels"],
                num_epochs=EPOCHS, lr=PAR_LR, eager=name == "eager"))
            out[name] = {"best_m": best_m, "best_l": best_l, "wall": wall, "counts": counts,
                         "calls": dict(calls)}
    finally:
        programs.run, sh.all_reduce = run, reduce
    out["captures"] = list(programs.captures)
    # the path's launches: the default run's, the programs' (with their captures)
    out["counts"] = out["programs"]["counts"]
    return out


def _par_inputs(dev, frames: np.ndarray) -> tuple[dict, dict]:
    """[12c] and [12d]'s inputs from four of [11]'s sequences: the port's
    frame-0 segmentation at seed 0 (per sequence for the training step, of
    sequence 0 for the registration, as ``run_registration`` does) and MLP
    weights drawn from seed 1."""
    from autourdf_tpu_torch.models.regmlp import PoseRegressor
    from autourdf_tpu_torch.registration import initial_segments

    f = np.ascontiguousarray(frames[:PAR_SEQS, :PAR_FRAMES])
    ft = torch.from_numpy(f).to(dev)
    inits = [initial_segments(torch.Generator(device=dev).manual_seed(0), ft[s, 0], PAR_K,
                              n_init=10) for s in range(PAR_SEQS)]
    params = lambda seed: {k: v.detach().numpy() for k, v in PoseRegressor(
        "q", PAR_HIDDEN, num_seqs=PAR_SEQS,
        generator=torch.Generator().manual_seed(seed)).named_parameters()}
    step = {"mats": torch.stack([i.matrices for i in inits]).cpu().numpy(),
            "points": torch.stack([i.points for i in inits]).cpu().numpy(),
            "labels": torch.stack([i.labels for i in inits]).cpu().numpy(),
            "targets": f[:, 1], "params": params(1)}
    reg = {"init": tuple(t.cpu().numpy() for t in inits[0][:3]), "frames": f,
           "step": params(1), "anchor": params(2)}
    return step, reg


def _shard_inputs(seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    cases = []
    for n, m, masked in SHARD_CASES:
        cases.append({"x": rng.normal(scale=0.3, size=(n, 3)).astype(np.float32),
                      "y": rng.normal(scale=0.3, size=(m, 3)).astype(np.float32),
                      "xm": rng.random(n) < 0.9 if masked else None,
                      "ym": rng.random(m) < 0.85 if masked else None})
    return cases


def _check_shard_shapes(dev, cases: list) -> None:
    """[12]'s kernels at the shapes its ranks give them, each held bit for
    bit against its plain version on the same inputs, before any rank
    starts: each rank's search in [12a] (x whole, masked points at the
    sentinel, against the rank's ``ceil(M / 2)`` rows of y, as
    ``sharded_search`` cuts them), a dp rank's search in [12c] (2
    sequences of 5,000 points against an sp rank's 2,500 target rows) and
    in [12d] (2 sequences against their whole 5,000-point frames, indexed
    and min-only).  The [12c] and [12d] clouds carry forced ties."""
    from autourdf_tpu_torch.ops import knn
    from autourdf_tpu_torch.parallel.sharding import _shard_rows

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    checks = []
    for (n, m, masked), c in zip(SHARD_CASES, cases):
        x, y = (torch.from_numpy(c[k]).to(dev) for k in ("x", "y"))
        if masked:
            x, y = (torch.where(torch.from_numpy(c[k]).to(dev)[:, None], t, knn.PAD_COORD)
                    for k, t in (("xm", x), ("ym", y)))
        for rank in range(2):
            rows = _shard_rows(m, 2, rank)
            checks.append((f"[12a] N={n}{' masked' if masked else ''}, rank {rank}'s "
                           f"y[{rows.start}:{rows.stop}]", x[None], y[None, rows], False))
    rng = np.random.default_rng(12)
    for label, (S, N, M), light in (("[12c] a (dp, sp) rank", (PAR_SEQS // 2, 5000, 2500), False),
                                    ("[12d] a dp rank", (PAR_SEQS // 2, 5000, 5000), True)):
        x, y = (torch.from_numpy(a).to(dev) for a in tie_layout_clouds(rng, S, N, M))
        checks.append((label, x, y, light))
    for label, x, y, light in checks:
        S, N, M = x.shape[0], x.shape[1], y.shape[1]
        plan = knn.pick_bidir_plan(S, N, M, sms)
        t0 = time.time()
        ref = knn._nn_bidir_plain(x, y, 1)
        torch.cuda.synchronize(dev)
        plain_s = time.time() - t0
        got = knn.nn_search_bidirectional(x, y, 1)
        same = all(torch.equal(a, b) for a, b in zip(got, ref, strict=True))
        line = (f"  {label}: S={S} N={N} M={M}, {plan.kernel} (the plan's pick) equal to plain "
                f"{same}")
        if light:
            same_min = all(torch.equal(a, b) for a, b in zip(
                knn.nn_min_bidirectional(x, y, 1), knn._nn_min_bidir_plain(x, y, 1), strict=True))
            line += f", nn_min_bidir equal to plain {same_min}"
            same = same and same_min
        print(f"{line}; plain search {plain_s:.3f} s")
        if not same:
            _fail(f"{label}: a search kernel disagrees with its plain version at S={S} N={N} M={M}")
    torch.cuda.empty_cache()


def _check_dp_sp(dev, step: dict, four: list, note: str) -> None:
    """[12c]: each rank's three runs (programs, replayed, eager) against the
    single-process ``train_init`` + ``train_epochs`` on the card, bit for
    bit, with the same launches, two program calls and two sp all-reduces
    an epoch."""
    from autourdf_tpu_torch.models.regmlp import PoseRegressor
    from autourdf_tpu_torch.registration.optimizer import train_epochs, train_init

    model = PoseRegressor("q", PAR_HIDDEN, num_seqs=PAR_SEQS, device=dev)
    theta = model.flat_params({k: torch.from_numpy(v) for k, v in step["params"].items()})
    mats = torch.from_numpy(step["mats"]).to(dev)

    def plain_step():
        carry = train_init(theta, mats, PAR_LR)
        carry, _ = train_epochs(model, carry, mats, torch.from_numpy(step["targets"]).to(dev),
                                torch.from_numpy(step["points"]).to(dev),
                                torch.from_numpy(step["labels"]).to(dev), EPOCHS)
        return carry

    carry, wall, _ = _counted(plain_step)
    for rank, r in enumerate(four):
        for name in ("programs", "replayed", "eager"):
            g = r[name]
            dl = float((g["best_l"].to(dev) - carry.best_loss).abs().max())
            dm = float((g["best_m"].to(dev) - carry.best_m).abs().max())
            print(f"  [12c] rank {rank}, {name}: train_step_dp_sp on (dp 2, sp 2), {PAR_SEQS} "
                  f"sequences, frame pair 0->1, K={PAR_K}, hidden {PAR_HIDDEN}, {EPOCHS} epochs: "
                  f"best losses {np.round(g['best_l'].numpy(), 7).tolist()}, max |loss - single| "
                  f"{dl:.3e}, max |matrix - single| {dm:.3e}; {g['wall']:.3f} s, "
                  f"{1e3 * g['wall'] / EPOCHS:.3f} ms an epoch, "
                  f"against {wall:.3f} s single-process ({note}); calls in {EPOCHS} epochs "
                  f"{g['calls']} (train_init and the dp assembly once); launches "
                  f"{g['counts']}")
            if dl or dm or not all(torch.equal(g[k], r["eager"][k]) for k in ("best_m", "best_l")):
                _fail(f"[12c] the (dp, sp) training step ({name}) differs from the eager one or "
                      f"the single-process one")
            if g["counts"] != r["eager"]["counts"]:
                _fail(f"[12c] rank {rank}'s {name} launches differ from the eager loop's")
        if r["programs"]["calls"].get("all-reduces over sp") != 2 * EPOCHS:
            _fail(f"[12c] rank {rank} did not run two sp all-reduces an epoch")
        if r["programs"]["calls"].get("program calls") != 1 + 2 * EPOCHS:
            _fail(f"[12c] rank {rank} did not call two programs an epoch")
        print(f"  [12c] rank {rank}'s programs:")
        _print_captures(r["captures"])
        if r["counts"]["nn_bidir"] + r["counts"]["nn_bidir_acc"] < 1:
            _fail(f"[12c] rank {rank} did not launch an indexed search kernel")


def run_parallel(dev, loop: dict) -> dict:
    """Phase 12: the parallel layer with several ranks on the one card (gloo,
    CUDA tensors), each against the single-process path on the card."""
    from autourdf_tpu_torch.models.regmlp import PoseRegressor
    from autourdf_tpu_torch.ops import chamfer
    from autourdf_tpu_torch.ops.knn import nn_search_bidirectional
    from autourdf_tpu_torch.parallel import launch
    from autourdf_tpu_torch.registration import (RegistrationConfig, SegmentInit,
                                                 register_sequences_batched)

    note = "two ranks on one card, says nothing of multi-card scaling"
    cases = _shard_inputs()
    _check_shard_shapes(dev, cases)
    step, reg = _par_inputs(dev, loop["frames"])
    rng = np.random.default_rng(1)
    reg["auto_x"] = rng.normal(scale=0.3, size=(AUTO_SHARD_M, 3)).astype(np.float32)
    reg["auto_y"] = rng.normal(scale=0.3, size=(AUTO_SHARD_M, 3)).astype(np.float32)

    t0 = time.time()
    two = launch.run(rank_sp2_dp2, 2, (cases, reg), device="cuda")
    t_two = time.time() - t0
    t0 = time.time()
    four = launch.run(rank_dp_sp, 4, (step,), device="cuda")
    t_four = time.time() - t0
    print(f"  spawned 2 ranks ([12a] [12b] [12d]) in {t_two:.3f} s and 4 ranks ([12c]) in "
          f"{t_four:.3f} s of wall time, start-up included ({launch.backend_for('cuda', 2)}, "
          f"{note})")

    # [12a]
    for i, ((n, m, masked), c) in enumerate(zip(SHARD_CASES, cases)):
        x, y, xm, ym = _shard_case(c, dev)
        chamfer.chamfer_distance(x, y, xm, ym).backward()
        x.grad = y.grad = None

        def single():
            loss = chamfer.chamfer_distance(x, y, xm, ym)
            loss.backward()
            return loss.detach()

        loss, wall, _ = _counted(single)
        _, ix, _, _ = nn_search_bidirectional(_masked_copy(x, xm), _masked_copy(y, ym))
        valid = torch.ones(n, dtype=torch.bool, device=dev) if xm is None else xm
        for rank, r in enumerate(two):
            rc = r["cases"][i]
            errs = (abs(float(rc["loss"]) - float(loss)) / abs(float(loss)),
                    float((rc["gx"].to(dev) - x.grad).abs().max()),
                    float((rc["gy"].to(dev) - y.grad).abs().max()),
                    int((rc["idx"].to(dev)[valid] != ix[valid]).sum()))
            print(f"  [12a] N={n} M={m}{' bool masks' if masked else ''}, rank {rank}: loss "
                  f"{float(rc['loss']):.9f} (single {float(loss):.9f}, rel err {errs[0]:.3e}), "
                  f"max |dx.grad| {errs[1]:.3e}, max |dy.grad| {errs[2]:.3e}, indices that "
                  f"differ {errs[3]}; forward + backward {rc['wall'] * 1e3:.3f} ms sharded "
                  f"against {wall * 1e3:.3f} ms single-process ({note}); launches "
                  f"{rc['counts']}")
            if not (errs[0] <= CHAMFER_RTOL and errs[1] <= GRAD_ATOL and errs[2] <= GRAD_ATOL
                    and errs[3] == 0):
                _fail(f"[12a] the sharded Chamfer differs from the single-process one: {errs}")
            if rc["counts"]["nn_bidir"] + rc["counts"]["nn_bidir_acc"] < 1:
                _fail(f"[12a] rank {rank} did not launch an indexed search kernel")

    # [12b]
    x, y = (torch.from_numpy(reg[k]).to(dev) for k in ("auto_x", "auto_y"))
    with torch.no_grad():
        plain = float(chamfer.chamfer_distance(x, y))
    for rank, r in enumerate(two):
        a = r["auto"]
        err = abs(float(a["loss"]) - plain) / plain
        print(f"  [12b] rank {rank}: chamfer_distance at M={AUTO_SHARD_M} (threshold "
              f"{a['threshold']}) inside mesh_scope: {a['calls']} sharded call(s), loss "
              f"{float(a['loss']):.9f} against {plain:.9f} unscoped (rel err {err:.3e})")
        if a["calls"] != 1 or err > CHAMFER_RTOL:
            _fail("[12b] chamfer_distance did not shard inside the scope, or differs")

    # [12c]
    _check_dp_sp(dev, step, four, note)

    # [12d]
    model = PoseRegressor("q", PAR_HIDDEN, num_seqs=PAR_SEQS, device=dev)
    cfg = RegistrationConfig(num_seg=PAR_K, hidden_dim=PAR_HIDDEN, epochs=EPOCHS)
    to_t = lambda p: {k: torch.from_numpy(v).to(dev) for k, v in p.items()}
    ref, wall, _ = _counted(lambda: register_sequences_batched(
        model, cfg, to_t(reg["step"]), to_t(reg["anchor"]),
        SegmentInit(*(torch.from_numpy(a).to(dev) for a in reg["init"])),
        torch.from_numpy(reg["frames"]).to(dev)))
    for rank, r in enumerate(two):
        g = r["reg"]
        res = g["result"]
        dl = float((res.losses.to(dev) - ref.losses).abs().max())
        dlab = int((res.labels.to(dev) != ref.labels).sum())
        print(f"  [12d] rank {rank}: register_sequences_sharded on dp 2, {PAR_SEQS} sequences x "
              f"{PAR_FRAMES} frames, K={PAR_K}, hidden {PAR_HIDDEN}, {EPOCHS} epochs: losses "
              f"{np.round(res.losses.numpy(), 7).tolist()}, max |loss - single| {dl:.3e}, "
              f"labels that differ {dlab}, last-frame residual "
              f"{[round(float(v), 9) for v in g['resid']]}; {g['wall']:.3f} s against "
              f"{wall:.3f} s single-process ({note}); launches {g['counts']}")
        if dl > REG_ATOL or dlab:
            _fail("[12d] the dp registration differs from the single-process one")
        if g["counts"]["nn_bidir"] + g["counts"]["nn_bidir_acc"] < 1 or \
                g["counts"]["nn_min_bidir"] < 1:
            _fail(f"[12d] rank {rank} did not launch the indexed and the min-only kernels")
    counts = collections.Counter()
    for r in two + four:
        counts.update(r["counts"])
    print(f"  launches of every rank: {dict(counts)}")
    from autourdf_tpu_torch.ops import _cuda

    return {"counts": {k: counts.get(k, 0) for k in _cuda.launch_counts}}


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB PNG whose rows are unfiltered (filter
    type 0, as ``viz.write_png`` writes them); checks the signature and every
    chunk's CRC."""
    import struct
    import zlib

    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in {kind}")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype = head[:4]
    if (depth, ctype) != (8, 2):
        raise ValueError(f"{path}: bit depth {depth}, colour type {ctype}: not 8-bit RGB")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError(f"{path}: filtered rows are not read")
    return raw[:, 1:].reshape(h, w, 3).copy()


def read_gif(path: str) -> tuple[list[np.ndarray], list[int], int | None]:
    """A GIF's frames as (H, W, 3) uint8 (one global palette, whole
    frames, as ``viz.write_gif`` writes them), each frame's delay in ms and
    the loop count (None without a NETSCAPE extension)."""
    import struct

    data = open(path, "rb").read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF")
    w, h, packed = struct.unpack("<HHB", data[6:11])
    pos = 13
    palette = None
    if packed & 0x80:
        n = 3 << ((packed & 7) + 1)
        palette = np.frombuffer(data[pos:pos + n], np.uint8).reshape(-1, 3)
        pos += n

    def blocks(p):
        out = bytearray()
        while data[p]:
            out += data[p + 1:p + 1 + data[p]]
            p += 1 + data[p]
        return bytes(out), p + 1

    frames, delays, loop, delay = [], [], None, 0
    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            label = data[pos + 1]
            body, pos = blocks(pos + 2)
            if label == 0xF9:
                delay = struct.unpack("<H", body[1:3])[0] * 10
            elif label == 0xFF and body.startswith(b"NETSCAPE2.0"):
                loop = struct.unpack("<H", body[12:14])[0]
            continue
        if data[pos] != 0x2C:
            raise ValueError(f"{path}: unexpected block {data[pos]:#x}")
        x0, y0, fw, fh, fpacked = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
        if (x0, y0, fw, fh) != (0, 0, w, h) or fpacked & 0xC0 or palette is None:
            raise ValueError(f"{path}: partial, interlaced or locally coloured frames "
                             f"are not read")
        min_size = data[pos + 10]
        code, pos = blocks(pos + 11)
        frames.append(palette[_lzw_decode(code, min_size, w * h)].reshape(h, w, 3))
        delays.append(delay)
    return frames, delays, loop


def _lzw_decode(code: bytes, min_size: int, count: int) -> np.ndarray:
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    bits = int.from_bytes(code, "little")
    nbits, pos = len(code) * 8, 0
    out = bytearray()
    table, size, prev = None, min_size + 1, None
    while pos + size <= nbits:
        c = (bits >> pos) & ((1 << size) - 1)
        pos += size
        if c == clear:
            table = [bytes([i]) for i in range(clear)] + [b"", b""]
            size, prev = min_size + 1, None
            continue
        if c == eoi:
            break
        if prev is None:
            entry = table[c]
        else:
            entry = table[c] if c < len(table) else prev + prev[:1]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        out += entry
        prev = entry
        if len(table) == (1 << size) and size < 12:
            size += 1
    if len(out) != count:
        raise ValueError(f"LZW data gives {len(out)} pixels, expected {count}")
    return np.frombuffer(bytes(out), np.uint8)


def run_view(loop: dict) -> dict:
    """Phase 13: ``cli view --sweep --interactive`` on [11]'s recovered URDF;
    every output must parse."""
    import re

    from autourdf_tpu_torch import cli
    from autourdf_tpu_torch.urdf.parser import load_urdf

    out_dir = os.path.join(loop["root"], "view")
    log = os.path.join(loop["root"], "cli_view.log")
    t0 = time.time()
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        rc = cli.main(["view", "--urdf", loop["urdf"], "--out-dir", out_dir, "--sweep",
                       "--interactive"])
    wall = time.time() - t0
    with open(log) as f:
        outs = json.loads(f.read().splitlines()[-1])["outputs"]
    joints = [j.name for j in load_urdf(loop["urdf"], load_meshes=False).revolute_joints]
    expect = [os.path.join(out_dir, "snapshot.png"), os.path.join(out_dir, "interactive.html")]
    expect += [os.path.join(out_dir, f"sweep_{j}.gif") for j in joints]
    print(f"  cli view: exit {rc}, {wall:.3f} s (host work); {len(outs)} outputs for "
          f"{len(joints)} revolute joints")
    if rc != 0 or sorted(outs) != sorted(expect):
        _fail(f"cli view exited {rc} with outputs {outs}, expected {expect}")
    png = read_png(expect[0])
    drawn = int((png != 255).any(-1).sum())
    red = int(((png[..., 0] == 255) & (png[..., 1] == 0) & (png[..., 2] == 0)).sum())
    print(f"  snapshot.png: {png.shape[1]} x {png.shape[0]}, {drawn} pixels drawn, {red} of "
          f"them axis red")
    if drawn < 1000 or red < 10:
        _fail("the snapshot drew no robot or no joint axis")
    html = open(expect[1]).read()
    m = re.search(r"const SCENE = (\{.*?\});\n", html, re.S)
    scene = json.loads(m.group(1)) if m else {}
    tris = sum(len(v["faces"]) // 3 for v in scene.get("links", {}).values())
    print(f"  interactive.html: {len(html)} bytes, {len(scene.get('links', {}))} links, "
          f"{len(scene.get('joints', []))} joints, {tris} triangles")
    if not m or not tris or "http://" in html or "https://" in html:
        _fail("interactive.html holds no scene, no triangles, or an external link")
    for g in expect[2:]:
        frames, delays, loop_count = read_gif(g)
        moved = int(sum((a != b).any(-1).sum() for a, b in zip(frames, frames[1:])))
        print(f"  {os.path.basename(g)}: {len(frames)} frames of {frames[0].shape[1]} x "
              f"{frames[0].shape[0]}, {delays[0]} ms each, loop {loop_count}, {moved} pixels "
              f"change between frames")
        if len(frames) != 16 or set(delays) != {250} or loop_count != 0 or moved < 1:
            _fail(f"{g}: {len(frames)} frames, delays {set(delays)}, loop {loop_count}, "
                  f"{moved} pixels moved")
    return {"seconds": wall}


# ---------------------------------------------------------------------------
# Phase 14: the registration against the JAX package's from the same draw
#
# the JAX package's registration of data_real/raw/wx200_real_5 on the CPU from
# its own segmentation at seed 0 and the port's MLP weights at seed 0
# (scripts/torch_same_draw.py record)
SAME_DRAW_RECORD = os.path.join("tests", "data", "same_draw_wx200_real_5_seed0.npz")
# the largest relative gap of a best loss of frame pair 0->1 (either phase,
# any sequence) between the port and the JAX package, both on the CPU from
# the record's draw, over two runs of the slow test of
# tests/test_torch_same_draw.py: 0.05471 and 0.06285, both sequence V0003's
# anchor phase (the port's CPU results at this size then differed between
# runs in their last bits, even between two calls in one process: the
# Chamfer backward's accumulating index_put_ adds with atomics across CPU
# threads, since replaced by scatter_add_ there; the parting amplifies such
# bits); the other four sequences part by at most 3.7e-3.
# The card's arithmetic is another order of the same sums, a draw of the
# same amplification of round-off, so it may part as far; the factor leaves
# room for that, and the card fails beyond three times the CPU's worst.
SAME_DRAW_CPU_GAP, SAME_DRAW_FACTOR = 0.0629, 3
# a loss history "parts" where its relative gap first exceeds this
HISTORY_RTOL = 1e-6
# the poses of two registrations that agree (the 12-epoch parity test's
# tolerance, tests/test_torch_registration.py)
SAME_DRAW_POSE_ATOL = 1e-5


def port_structure(cfg, dev) -> dict:
    """The port's unknown-DoF link partition before its chain fits, on the
    artifacts of ``cfg``: link counts after the DoF search, the carry
    reassignment and the rigidity guard, the final partition (a link index a
    cluster) and each link's rigidity over the guard's floor
    (``partition_rigidity`` of the link alone; 0 for a one-cluster link).
    ``scripts/torch_same_draw.py jax_structure`` is the JAX package's."""
    from autourdf_tpu_torch import structure, workflow

    cms, _ = workflow.build_coord_maps(cfg, None, cfg.start_steps, cfg.end_steps)
    sum_map = structure.combined_sum_map(cms, "pose", device=dev)
    groups, _, _, _ = structure.auto_dof_search(sum_map)
    counts = [len(groups)]
    stack = structure.swap_consistency_stack(cms, device=dev)
    groups = structure.refine_groups_by_carry(cms, groups, verbose=False, stack=stack,
                                              device=dev)
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
    return {"counts": counts, "partition": partition.tolist(),
            "link_rigidity": [round(float(r), 4) for r in rig], "floor": float(floor),
            "pre_guard_rigidity": float(pre), "guard_fired": bool(fired)}


def record_structure(rec) -> dict:
    """The JAX structure the same-draw record holds, keyed as
    :func:`port_structure`'s."""
    return {"counts": rec["structure_counts"].tolist(),
            "partition": rec["structure_partition"].tolist(),
            "link_rigidity": [round(float(r), 4) for r in rec["structure_link_rigidity"]],
            "floor": float(rec["structure_floor"]),
            "pre_guard_rigidity": float(rec["structure_pre_guard_rigidity"])}


def check_record_weights(rec, params: tuple) -> None:
    """Fail unless the record's weight checksum is the port's draw ``params``
    ((step, anchor) state dicts, on the CPU): each tensor's first 8 values
    bit for bit, and its float64 sum to 1e-12 relative (numpy's sum groups
    its additions by the host's vector width)."""
    names = [str(n) for n in rec["weight_names"]]
    for i, (phase, p) in enumerate(zip(("step", "anchor"), params)):
        flat = [p[n].detach().cpu().numpy().reshape(-1) for n in names] \
            if names == sorted(p) else None
        if flat is None or not (
                np.allclose(rec["weight_sum"][i], [f.astype(np.float64).sum() for f in flat],
                            rtol=1e-12, atol=0)
                and np.array_equal(rec["weight_head"][i], np.stack([f[:8] for f in flat]))):
            _fail(f"the same-draw record's {phase} weights are not the port's draw at seed "
                  f"{int(rec['seed'])}: regenerate {SAME_DRAW_RECORD} with "
                  f"scripts/torch_same_draw.py record")


def _rel(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Relative gap of ``a`` to ``b``; 0 where both are inf (both frozen)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.abs(a - b) / np.abs(b)
    out[np.isinf(a) & np.isinf(b)] = 0.0
    out[np.isinf(a) ^ np.isinf(b)] = np.inf
    return out


def _rebuilt_record(rec, frames: np.ndarray, masks: np.ndarray, dev):
    """The record's registration as the port's ``(matrices, local points,
    labels, losses)`` arrays: frame 0 is the init in every sequence, later
    frames' local points come from ``local_points_from_labels``."""
    from autourdf_tpu_torch.registration import local_points_from_labels

    S, T = rec["matrices"].shape[:2]
    m = torch.from_numpy(rec["matrices"]).to(dev)
    lab = torch.from_numpy(rec["labels"].astype(np.int64)).to(dev)
    pts = local_points_from_labels(m[:, 1:], torch.from_numpy(frames[:, 1:]).to(dev),
                                   lab[:, 1:]).cpu().numpy()
    init = np.broadcast_to(rec["init_points"][None, None], (S, 1) + rec["init_points"].shape)
    return rec["matrices"], np.concatenate([init, pts], 1), rec["labels"].astype(np.int64), \
        rec["losses"]


def run_same_draw(dev, root: str) -> dict:
    """Phase 14: register the real scans on the card from the same-draw
    record's init and the port's weights at seed 0, at the defaults, and hold
    the result against the JAX package's registration in the record: per
    frame pair the gaps of the best losses, poses and labels, the first pair
    and phase that part, on pair 0->1 the per-epoch loss histories, and the
    port's structure on both registrations beside the record's."""
    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.config import PipelineConfig
    from autourdf_tpu_torch.ops import _cuda
    from autourdf_tpu_torch.registration import (RegistrationConfig, SegmentInit,
                                                 register_sequences_batched, train_pose_mlp)

    rec = np.load(os.path.join(REPO, SAME_DRAW_RECORD))
    seed, S = int(rec["seed"]), len(rec["names"])
    _, sp, ap = workflow._draw_weights(S, seed, "cpu")
    check_record_weights(rec, (sp, ap))
    cfg = PipelineConfig(robot="wx200_real_5", data_root=os.path.join(REPO, "data_real"))
    names, frames, masks = workflow.load_raw_sequences_padded(cfg.raw_dir(), cfg.num_videos)
    if names != [str(n) for n in rec["names"]] or frames.shape[2] != int(rec["n_capacity"]):
        _fail("the same-draw record was made from other scans")
    T = frames.shape[1]
    ft, mt = torch.from_numpy(frames).to(dev), torch.from_numpy(masks).to(dev)
    init = SegmentInit(torch.from_numpy(rec["init_matrices"]).to(dev),
                       torch.from_numpy(rec["init_points"]).to(dev),
                       torch.from_numpy(rec["init_labels"].astype(np.int64)).to(dev),
                       torch.from_numpy(rec["init_mask"]).to(dev))
    model, sp, ap = workflow._draw_weights(S, seed, dev)
    reg_cfg = RegistrationConfig(num_seg=int(rec["init_matrices"].shape[0]),
                                 epochs=int(rec["epochs"]))

    _cuda.reset_launch_counts()
    torch.cuda.synchronize(dev)
    t0 = time.time()
    res = register_sequences_batched(model, reg_cfg, sp, ap, init, ft, mt)
    torch.cuda.synchronize(dev)
    seconds = time.time() - t0
    counts = dict(_cuda.launch_counts)

    # pair 0->1 once more, phase by phase, for the per-epoch histories
    tile = lambda x: x[None].expand((S,) + x.shape)
    step = train_pose_mlp(model, model.flat_params(sp), tile(init.matrices), ft[:, 1],
                          tile(init.points), tile(init.labels), mt[:, 1], tile(init.mask),
                          epochs=reg_cfg.epochs, learning_rate=reg_cfg.lr_step)
    anchor = train_pose_mlp(model, model.flat_params(ap), step.best_matrices, ft[:, 1],
                            tile(init.points), tile(init.labels), mt[:, 1], tile(init.mask),
                            epochs=reg_cfg.epochs, learning_rate=reg_cfg.lr_anchor)
    if not (torch.equal(step.best_loss, res.step_losses[:, 0])
            and torch.equal(anchor.best_loss, res.losses[:, 0])):
        _fail(f"pair 0->1 run phase by phase differs from the batched driver's: "
              f"{step.best_loss.tolist()} {res.step_losses[:, 0].tolist()} "
              f"{anchor.best_loss.tolist()} {res.losses[:, 0].tolist()}")

    card = {k: getattr(res, k).cpu().numpy() for k in ("matrices", "labels", "losses",
                                                      "step_losses")}
    gap = {"step": _rel(card["step_losses"], rec["step_losses"]),
           "anchor": _rel(card["losses"], rec["losses"])}
    valid = np.concatenate([np.broadcast_to(rec["init_mask"][None, None], (S, 1, frames.shape[2])),
                            masks[:, 1:]], 1)
    label_diff = ((card["labels"] != rec["labels"]) & valid).sum(-1)        # (S, T)
    dmat = np.abs(card["matrices"] - rec["matrices"]).max(axis=(-1, -2, -3))  # (S, T)
    print(f"  {S} sequences x {T} frames, K={reg_cfg.num_seg}, hidden {reg_cfg.hidden_dim}, "
          f"{reg_cfg.epochs} epochs, from the record's init and the port's weights at seed "
          f"{seed} (checksum equal); registration {seconds:.3f} s; launches {counts}")
    print("  card against the record, per sequence and frame pair 1..9: relative gap of the "
          "best step / anchor loss, max |d matrix|, labels that differ")
    fmt = lambda v: "[" + " ".join(f"{x:.2e}" for x in v) + "]"
    for s in range(S):
        print(f"  {names[s]}: step {fmt(gap['step'][s])}; anchor {fmt(gap['anchor'][s])}; "
              f"|dm| {fmt(dmat[s, 1:])}; labels {label_diff[s, 1:].tolist()}")
    tol = SAME_DRAW_CPU_GAP * SAME_DRAW_FACTOR
    first = next(((s, t + 1, ph) for t in range(T - 1) for s in range(S)
                  for ph in ("step", "anchor") if gap[ph][s, t] > tol), None)
    print(f"  tolerance {tol:.3g} (the CPU's pair-0->1 gap {SAME_DRAW_CPU_GAP} x "
          f"{SAME_DRAW_FACTOR}); first (sequence, pair, phase) beyond it: "
          + ("none" if first is None else f"({names[first[0]]}, {first[1] - 1}->{first[1]}, "
                                           f"{first[2]})"))
    for ph, hist in (("step", step), ("anchor", anchor)):
        h = _rel(hist.loss_history.cpu().numpy(), rec[f"history_{ph}"])
        over = np.nonzero((h > HISTORY_RTOL).any(0))[0]
        at = {e: float(h[:, e - 1].max()) for e in (1, 10, 100, 300) if e <= h.shape[1]}
        where = "none" if not len(over) else (
            f"{int(over[0]) + 1} (sequence {names[int(np.argmax(h[:, over[0]] > HISTORY_RTOL))]})")
        print(f"  pair 0->1 {ph} phase: first epoch whose loss leaves the record's by more than "
              f"{HISTORY_RTOL:g} relative: {where}; largest gap at epochs {at}")

    structures = {"record (JAX)": record_structure(rec)}
    for label, arrays in (("record, port build", _rebuilt_record(rec, frames, masks, dev)),
                          ("card, port build", (card["matrices"], res.local_points.cpu().numpy(),
                                                card["labels"], card["losses"]))):
        data_root = os.path.join(root, label.split(",")[0])
        os.makedirs(data_root)
        os.symlink(os.path.join(REPO, "data_real", "raw"), os.path.join(data_root, "raw"))
        c = PipelineConfig(robot="wx200_real_5", data_root=data_root)
        workflow._save_registrations(c, names, *arrays, masks)
        structures[label] = port_structure(c, dev)
    for label, st in structures.items():
        print(f"  structure, {label}: links after the DoF search, the carry reassignment and "
              f"the guard {st['counts']}; partition {st['partition']}; link rigidity over the "
              f"floor {st['link_rigidity']} (floor {st['floor']:.6f}, before the guard "
              f"{st['pre_guard_rigidity']:.3f})")

    if not all(np.isfinite(card[k]).all() for k in card):
        _fail("non-finite values in the same-draw registration")
    pair0 = max(float(gap["step"][:, 0].max()), float(gap["anchor"][:, 0].max()))
    if not pair0 <= tol:
        _fail(f"the card parts from the JAX record at pair 0->1 by {pair0:.3g} relative, beyond "
              f"{tol:.3g}")
    same = lambda a, b: a["counts"] == b["counts"] and a["partition"] == b["partition"]
    ref = structures["record (JAX)"]
    if not same(ref, structures["record, port build"]):
        _fail("the port's build on the record's registration differs from the JAX build on it")
    # the registrations agree where every pair's best losses are within the
    # tolerance and the poses and labels are the record's too: a loss
    # tolerance wide enough for the parted trajectories says nothing of the
    # clusters the build reads
    agree = first is None and label_diff.max() == 0 and dmat.max() <= SAME_DRAW_POSE_ATOL
    if agree and not same(ref, structures["card, port build"]):
        _fail("the registrations agree at every pair, yet the port's structure on the card's "
              "differs from the record's")
    return {"counts": counts}


def _print_captures(records: list) -> None:
    for r in records:
        print(f"    program {r['name']}: capture {r['capture_s']:.3f} s, instantiate "
              f"{r['instantiate_s']:.3f} s, "
              f"{r['nodes']} nodes, pool {r['pool_bytes'] / 2**20:.1f} MiB, launches a call "
              f"{r['launches']}")


# the modules whose ICP calls [15] replays eagerly: the structure's link ICP,
# the chain fit's canonical-union polish, the evaluation's resim alignment
ICP_SITES = {"link": "autourdf_tpu_torch.structure.links",
             "polish": "autourdf_tpu_torch.joints.chain",
             "resim": "autourdf_tpu_torch.eval.resim"}


@contextlib.contextmanager
def _recording_icps(records: dict):
    """While the block runs, keep the first ICP call of each site of
    ``ICP_SITES`` (its arguments and its result, cloned) in ``records``."""
    mods = {site: importlib.import_module(name) for site, name in ICP_SITES.items()}
    originals = {site: m.icp_point_to_point for site, m in mods.items()}

    def clone(v):
        return v.clone() if isinstance(v, torch.Tensor) else v

    def recording(site, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            if site not in records:
                records[site] = ([clone(v) for v in a], {k: clone(v) for k, v in kw.items()},
                                 [clone(v) for v in out])
            return out
        return call

    for site, m in mods.items():
        m.icp_point_to_point = recording(site, originals[site])
    try:
        yield records
    finally:
        for site, m in mods.items():
            m.icp_point_to_point = originals[site]


def _check_site_icps(dev, records: dict, launched: dict) -> None:
    """[15]: each recorded site's ICP, eagerly and as a program on its own
    arguments: the program's result (in the run and here) equal to the eager
    loop's bit for bit, with the same launches; wall ms of the eager loop,
    of a fresh capture and of a replay."""
    from autourdf_tpu_torch.ops import _cuda
    from autourdf_tpu_torch.ops.icp import icp_point_to_point
    from autourdf_tpu_torch.utils import programs

    for site in ICP_SITES:
        if site not in records:
            _fail(f"no ICP of the {site} site was recorded")
        args, kw, in_run = records[site]
        times, outs = {}, {}
        for name in ("eager", "capture", "replay"):
            if name == "capture":
                programs.clear()
            before = dict(_cuda.launch_counts)
            torch.cuda.synchronize(dev)
            t0 = time.time()
            outs[name] = [o.clone() for o in icp_point_to_point(*args, eager=name == "eager", **kw)]
            torch.cuda.synchronize(dev)
            times[name] = 1e3 * (time.time() - t0)
            launched[f"{site} ICP {name}"] = {k: _cuda.launch_counts[k] - before[k] for k in before}
        same = all(all(torch.equal(a, b) for a, b in zip(outs[n], outs["eager"]))
                   for n in ("capture", "replay"))
        same_run = all(torch.equal(a, b) for a, b in zip(in_run, outs["eager"]))
        counts = dict(_cuda.launch_counts)      # the plain loop is a comparison, not a path
        with _plain_icp_step():
            plain = icp_point_to_point(*args, eager=True, **kw)
        _cuda.launch_counts.update(counts)
        gaps = [float((a - b).abs().max()) for a, b in zip(outs["eager"], plain)]
        shape = tuple(args[0].shape)
        print(f"  {site} ICP {shape} against {tuple(args[1].shape)}, "
              f"{kw.get('max_iterations', 50)} iterations: program equal to the eager loop "
              f"{same}, the run's result equal {same_run}; eager {times['eager']:.3f} ms, "
              f"program {times['capture']:.3f} ms with its capture, {times['replay']:.3f} ms "
              f"replayed; launches {launched[f'{site} ICP replay']}; against the plain loop on "
              f"the card (its step in plain PyTorch): max |T diff| {gaps[0]:.3g} (tol "
              f"{SITE_ICP_T_ATOL}), fitness {gaps[1]:.3g}, RMSE {gaps[2]:.3g}")
        if not (same and same_run) or len({str(launched[f"{site} ICP {n}"])
                                             for n in ("eager", "capture", "replay")}) != 1:
            _fail(f"the {site} ICP's program differs from its eager loop")
        if not gaps[0] <= SITE_ICP_T_ATOL:
            _fail(f"the {site} ICP differs from the plain loop on the card by {gaps[0]}")


@contextlib.contextmanager
def _plain_icp_step():
    """In this block the ICP loop takes its plain step (``svd``, ``det``) in
    place of ``icp_kabsch_kernel``."""
    from autourdf_tpu_torch.ops import icp

    kernel = icp.kabsch_step
    icp.kabsch_step = icp._kabsch_step_plain
    try:
        with _solvers_allowed():
            yield
    finally:
        icp.kabsch_step = kernel


def run_programs(dev, root: str, cfg, build: dict, icps: dict) -> dict:
    """Phase 15: the programs against the eager loops on the card.  [4c]'s
    subset (2 sequences x 4 frames of the real scans, seed 0, K=20, hidden
    512, 300 epochs), and the same with [7]'s options (``mlp_icp``, normals,
    FPS seeds), three ways: the eager loop, the batched driver's phase
    programs and the fused frame-pair program, whose matrices, labels and
    losses must be equal bit for bit; then [9b]'s chain fit (the known-DoF
    build's links, 1,024 points a link) for 120 steps eager and in 50-step
    programs, whose axes, origins, angles and step losses must be equal bit
    for bit; then the link, polish and resim ICPs recorded in ``icps`` in
    their programs against their eager loops, bit for bit.  Every capture
    is made anew here and reported: capture and instantiation seconds, graph
    nodes, pool bytes."""
    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.config import PipelineConfig
    from autourdf_tpu_torch.joints.chain import refine_chain
    from autourdf_tpu_torch.ops import _cuda
    from autourdf_tpu_torch.registration import (register_sequences_batched,
                                                 register_sequences_fused)
    from autourdf_tpu_torch.utils import programs

    _real_scan_subset(root, 2, 4)
    programs.clear()
    programs.captures.clear()
    _cuda.reset_launch_counts()
    launched = {}
    for label, options in (("[4c]'s", dict()),
                           ("[7]'s", dict(mlp_icp=True, use_normals=True, seed_mode="fps"))):
        seed_mode = options.pop("seed_mode", "kmeans++")
        sub = PipelineConfig(robot="wx200_real_5", data_root=root, rot="q", epochs=EPOCHS,
                             num_videos=2, seed_mode=seed_mode)
        inp = workflow.registration_inputs(sub, seed=0, device=dev, **options)
        args = (inp["model"], inp["reg_cfg"], inp["step_params"], inp["anchor_params"],
                inp["init"], inp["frames"], inp["frame_masks"])
        regs = {}
        for name, run in (("eager", lambda: register_sequences_batched(*args, eager=True)),
                          ("batched", lambda: register_sequences_batched(*args)),
                          ("fused", lambda: register_sequences_fused(*args))):
            before = dict(_cuda.launch_counts)
            made = len(programs.captures)
            torch.cuda.synchronize(dev)
            t0 = time.time()
            regs[name] = run()
            torch.cuda.synchronize(dev)
            seconds = time.time() - t0
            launched[name] = {k: _cuda.launch_counts[k] - before[k] for k in before}
            print(f"  {label} registration, {name}: {seconds:.3f} s (captures included), "
                  f"launches {launched[name]}")
            _print_captures(programs.captures[made:])
        S, T = inp["frames"].shape[:2]
        for name in ("batched", "fused"):
            a, b = regs[name], regs["eager"]
            mat = float((a.matrices - b.matrices).abs().max())
            labels = int((a.labels != b.labels).sum())
            loss = max(float((a.losses - b.losses).abs().max()),
                       float((a.step_losses - b.step_losses).abs().max()))
            print(f"  {label} {name} against eager ({S} sequences x {T} frames): max |matrix "
                  f"diff| {mat}, labels that differ {labels}, max |loss diff| {loss}")
            if (mat, labels, loss) != (0.0, 0, 0.0) or not all(
                    torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields):
                _fail(f"the {name} registration programs differ from the eager loop ({label})")
            if launched[name] != launched["eager"]:
                _fail(f"the {name} programs counted other launches than the eager loop "
                      f"({label}): {launched[name]} against {launched['eager']}")
        expected = (T - 1) * (1 if options else 2) * EPOCHS
        if launched["eager"]["nn_bidir"] != expected:
            _fail(f"the eager registration launched nn_bidir {launched['eager']['nn_bidir']} "
                  f"times ({label})")
        if options and launched["eager"]["icp_kabsch"] != (T - 1) * ICP_ITERATIONS:
            _fail(f"the eager registration launched icp_kabsch {launched['eager']['icp_kabsch']} "
                  f"times ({label})")

    cms, _ = workflow.build_coord_maps(cfg, 5, cfg.start_steps, cfg.end_steps)
    frames, fmasks = workflow._load_refine_frames(cfg, 5)
    fits = {}
    for name in ("eager", "graphed"):
        made = len(programs.captures)
        before = dict(_cuda.launch_counts)
        torch.cuda.synchronize(dev)
        t0 = time.time()
        fits[name] = refine_chain(build["links"], build["joints"], cms, frames, steps=120,
                                  points_per_link=1024, frame_masks=fmasks, freeze_probe=False,
                                  device=dev, eager=name == "eager")[1]
        torch.cuda.synchronize(dev)
        launched[f"chain {name}"] = {k: _cuda.launch_counts[k] - before[k] for k in before}
        print(f"  chain fit, {name}: 120 steps, {time.time() - t0:.3f} s (captures included), "
              f"launches {launched[f'chain {name}']}")
        _print_captures(programs.captures[made:])
    gaps = {f: float(np.abs(getattr(fits["graphed"], f) - getattr(fits["eager"], f)).max())
            for f in ("axes", "origins", "thetas", "step_losses")}
    print(f"  graphed chain fit against eager: max |diff| {gaps}")
    if any(gaps.values()) or launched["chain graphed"] != launched["chain eager"]:
        _fail("the chain-fit programs differ from the eager loop")
    _check_site_icps(dev, icps, launched)
    return {"counts": dict(_cuda.launch_counts)}


# [16]: refine_joints at its defaults on [6]'s known-DoF build; the CPU port
# from the same inputs for the first REVOLUTE_CPU_STEPS steps of each fit (a
# CPU step at T = 10, 2,048 points is some half a second, so whole fits on the
# CPU would not fit the run)
REVOLUTE_STEPS, REVOLUTE_CAP, REVOLUTE_CPU_STEPS = 200, 2048, 25


@contextlib.contextmanager
def _recording_fits(fits: list):
    """Keep every ``fit_revolute_joint`` call that ``refine_joints`` makes in
    the block: its arguments and its result, cloned."""
    from autourdf_tpu_torch.joints import refine

    fit = refine.fit_revolute_joint

    def call(*a, **kw):
        out = fit(*a, **kw)
        fits.append(([v.clone() for v in a], dict(kw), [v.clone() for v in out]))
        return out

    refine.fit_revolute_joint = call
    try:
        yield fits
    finally:
        refine.fit_revolute_joint = fit


def run_revolute(dev, cfg, build: dict) -> dict:
    """Phase 16: ``refine_joints`` on [6]'s known-DoF build (its joints and
    links, the first sequence's ``CoordMap``) three ways: the eager step
    loop, the chunk programs (their captures) and the programs replayed.
    First the search kernel at the fits' shape against its plain version.
    Every fit's axis, origin, angles and loss and every refined joint must be
    equal bit for bit, with the same launches, at least one of an indexed
    search; the axes unit vectors, ``thetas[0] == 0``, the losses finite.
    Prints wall ms a step, the captures and each fit's gap to the CPU port
    from the same inputs over its first ``REVOLUTE_CPU_STEPS`` steps (not
    gated)."""
    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.joints import refine
    from autourdf_tpu_torch.ops import knn
    from autourdf_tpu_torch.utils import programs

    cms, _ = workflow.build_coord_maps(cfg, 5, cfg.start_steps, cfg.end_steps)
    # the search kernel at the fits' shape (T clouds of point_cap points each
    # way, padded rows at the sentinel on both sides, forced ties) against its
    # plain version
    T = cms[0].coords.shape[0]
    x, y = (torch.from_numpy(a).to(dev) for a in tie_layout_clouds(
        np.random.default_rng(16), T, REVOLUTE_CAP, REVOLUTE_CAP))
    x[:, -200:] = y[:, -300:] = knn.PAD_COORD
    plan = knn.pick_bidir_plan(T, REVOLUTE_CAP, REVOLUTE_CAP,
                               torch.cuda.get_device_properties(dev).multi_processor_count)
    same = all(torch.equal(a, b) for a, b in zip(
        knn.nn_search_bidirectional(x, y, 1), knn._nn_bidir_plain(x, y, 1), strict=True))
    print(f"  the fits' search, S={T} N=M={REVOLUTE_CAP} with padded rows and ties: "
          f"{plan.kernel} (the plan's pick) equal to plain {same}")
    if not same:
        _fail("[16] the search kernel disagrees with its plain version at the fits' shape")
    programs.clear()
    runs = {}
    for name in ("eager", "programs", "replayed"):
        fits: list = []
        made = len(programs.captures)
        with _recording_fits(fits):
            joints, wall, counts = _counted(lambda: refine.refine_joints(
                build["joints"], build["links"], cms[0], steps=REVOLUTE_STEPS,
                point_cap=REVOLUTE_CAP, device=dev, eager=name == "eager"))
        runs[name] = dict(joints=joints, fits=fits, counts=counts)
        T = fits[0][0][0].shape[0] if fits else 0
        print(f"  {name}: {len(fits)} fits of {REVOLUTE_STEPS} steps (T = {T} frames, "
              f"point_cap {REVOLUTE_CAP}) in {wall:.3f} s, "
              f"{1e3 * wall / max(1, REVOLUTE_STEPS * len(fits)):.3f} ms a step (the run's "
              f"captures included); {len(programs.captures) - made} captures; launches {counts}")
        _print_captures(programs.captures[made:])
    eager = runs["eager"]
    for name in ("programs", "replayed"):
        r = runs[name]
        same = len(r["fits"]) == len(eager["fits"]) and all(
            torch.equal(a, b) for f, g in zip(r["fits"], eager["fits"]) for a, b in zip(f[2], g[2]))
        same = same and all(np.array_equal(getattr(a, f), getattr(b, f))
                            for a, b in zip(r["joints"], eager["joints"], strict=True)
                            for f in ("global_axis", "global_pos", "local_axis", "local_pos"))
        print(f"  {name} against eager: every fit and refined joint equal bit for bit {same}; "
              f"the same launches {r['counts'] == eager['counts']}")
        if not same or r["counts"] != eager["counts"]:
            _fail(f"[16] the revolute fit's {name} differ from its eager loop")
    fits = runs["programs"]["fits"]
    if not fits:
        _fail("[16] refine_joints fitted no joint")
    for j, (args, kw, (axis, origin, thetas, loss)) in enumerate(fits):
        norm = float(torch.linalg.norm(axis))
        print(f"  fit {j}: loss {float(loss):.7f}, |axis| {norm:.9f}, axis "
              f"{np.round(axis.cpu().numpy(), 6).tolist()}, origin "
              f"{np.round(origin.cpu().numpy(), 6).tolist()}, thetas[0] {float(thetas[0])}")
        if abs(norm - 1.0) > 1e-6 or float(thetas[0]) != 0.0 or not (
                math.isfinite(float(loss)) and bool(torch.isfinite(thetas).all())):
            _fail(f"[16] fit {j} gave a non-unit axis, a moved first angle or a non-finite loss")
    counts = runs["programs"]["counts"]
    if counts["nn_bidir"] + counts["nn_bidir_acc"] < 1:
        _fail("[16] the revolute fit did not launch an indexed search kernel")
    t0 = time.time()
    for j, (args, kw, _) in enumerate(fits):
        card = refine.fit_revolute_joint(*args, steps=REVOLUTE_CPU_STEPS)
        cpu = refine.fit_revolute_joint(*(a.cpu() for a in args), steps=REVOLUTE_CPU_STEPS,
                                        eager=True)
        a, b = (v.cpu().numpy().astype(np.float64) for v in (card.axis, cpu.axis))
        angle = math.degrees(math.atan2(np.linalg.norm(np.cross(a, b)), float(a @ b)))
        print(f"  fit {j} at {REVOLUTE_CPU_STEPS} steps, the card against the CPU port: axis "
              f"{angle:.3e} deg, max |origin diff| "
              f"{float((card.origin.cpu() - cpu.origin).abs().max()):.3e}, max |theta diff| "
              f"{float((card.thetas.cpu() - cpu.thetas).abs().max()):.3e}, loss "
              f"{float(card.loss):.9f} against {float(cpu.loss):.9f} (not gated)")
    print(f"  the CPU comparison took {time.time() - t0:.1f} s")
    return {"counts": counts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from autourdf_tpu_torch import workflow
    from autourdf_tpu_torch.config import PipelineConfig
    from autourdf_tpu_torch.ops import _cuda

    started = time.time()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[1] device {name} (count {torch.cuda.device_count()}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(gpu_line)

    t0 = time.time()
    # one nvcc a source, all started together
    with concurrent.futures.ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        list(pool.map(_cuda.build, CUDA_SOURCES))
    for src in CUDA_SOURCES:
        _cuda.library(src)
        log = _cuda.build_logs.get(src, "(cached)").strip()
        print(f"[2] built csrc/{src}.cu ({time.time() - t0:.1f} s for both); ptxas:\n{log}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        if spills:
            _fail(f"a kernel of {src}.cu spills registers: {spills[:2]}")
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
    _, frames, masks = workflow.load_raw_sequences_padded(cfg.raw_dir(), cfg.num_videos)
    print("[3] kernels against their plain versions")
    timing = check_kernels(dev, frames.shape[2])
    fullest = np.unravel_index(np.argmax(masks.sum(-1)), masks.shape[:2])
    timing.update(check_geom_kernels(dev, frames[fullest][masks[fullest]]))
    timing.update(check_epoch_update(dev))
    # from here on no path may reach PyTorch's solvers on the card: the
    # geometry kernels stand for them
    solvers = _forbid_cuda_solvers()

    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        roots = {k: os.path.join(tmp, k) for k in ("main", "icp", "large", "repro", "loop")}
        for r in roots.values():
            os.makedirs(r)
        print("[4] main path: workflow.run_registration on data_real/raw/wx200_real_5")
        paths["register"] = main_path = run_main_path(dev, gpu_line, roots["main"])
        print("[4b] where an epoch's time goes")
        profile_epochs(dev, main_path["n"])
        print("[4c] reproducibility: two registrations of the same scans at the same seed")
        run_reproducibility(dev, roots["repro"])
        print("[6] path B: workflow.run_build_urdf(refine='none', tree='mst') on the artifacts "
              "of [4]")
        icps: dict = {}             # the sites' first ICPs, which [15] replays eagerly
        with _recording_icps(icps):
            paths["urdf"], mst_build = run_urdf_stage(dev, main_path["cfg"])
        print("[7] path A: workflow.run_registration(mlp_icp=True, use_normals=True), FPS seeds")
        paths["register_icp"] = run_icp_path(dev, roots["icp"])
        print("[8] large clouds: workflow.run_registration at 20,000 points per frame")
        paths["register_large"] = run_large_cloud_path(dev, roots["large"])
        print("[9] path C: workflow.run_build_urdf with the defaults (chain fit, motion tree, "
              "probe ladder) on the artifacts of [4]")
        paths["urdf_default"], builds = run_default_urdf(dev, main_path["cfg"])
        for label, out in builds.items():
            print(f"[9b] where a chain-fit step's time goes ({label} build's links)")
            profile_chain_steps(dev, main_path["cfg"], out)
        print("[10] the chain fit's opt-in options: chain_anchors=2, canonical_frames=3, "
              "chain_trunc=2.0, 100 steps")
        with _recording_icps(icps):
            paths["urdf_chain_options"] = run_chain_options(dev, main_path["cfg"])
        print("[11] the closed loop: cli all (dataset -> register -> urdf -> evaluate) on the "
              "tracked wx200 estimate")
        with _recording_icps(icps):
            paths["closed_loop"] = loop = run_closed_loop(dev, roots["loop"])
        print("[12] the parallel layer: sharded Chamfer, auto-shard, (dp, sp) training step and "
              "dp registration, several ranks on the one card, on [11]'s clouds")
        paths["parallel"] = run_parallel(dev, loop)
        print("[13] cli view --sweep --interactive on [11]'s recovered URDF")
        run_view(loop)
        print("[14] the registration from the same draw as the JAX package's record "
              f"({SAME_DRAW_RECORD})")
        os.makedirs(os.path.join(tmp, "same_draw"))
        paths["same_draw"] = run_same_draw(dev, os.path.join(tmp, "same_draw"))
        print("[15] programs: the eager loops against the batched and fused registration "
              "programs (with and without [7]'s options), the chain-fit programs and the "
              "link, polish and resim ICPs' programs, bit for bit")
        os.makedirs(os.path.join(tmp, "programs"))
        paths["programs"] = run_programs(dev, os.path.join(tmp, "programs"), main_path["cfg"],
                                         builds["known DoF"], icps)
        print(f"[16] the revolute-joint fit: refine_joints on [6]'s known-DoF build "
              f"({REVOLUTE_STEPS} steps, point_cap {REVOLUTE_CAP}), eager, as programs and "
              f"replayed, bit for bit")
        paths["revolute"] = run_revolute(dev, main_path["cfg"], mst_build)

    sources = {"nn_bidir": "autourdf_tpu/ops/knn.py:149",
               "nn_min_bidir": "autourdf_tpu/ops/knn.py:313",
               "nn": "autourdf_tpu/ops/knn.py:54",
               "nn_bidir_acc": "autourdf_tpu/ops/knn.py:233",
               "fps": "autourdf_tpu/ops/fps.py:17",
               "icp_kabsch": "autourdf_tpu/ops/icp.py:50 (_kabsch) + :102-121 (step)",
               "pca_normals": "autourdf_tpu/ops/plane.py:79-88 (estimate_normals)",
               "epoch_update": "autourdf_tpu/registration/optimizer.py adam_update, "
                               "plateau_update, _epoch_step (XLA-fused; no Pallas kernel)"}
    files = {k: "autourdf_tpu_torch/csrc/geom.cu" if k in ("fps", "icp_kabsch", "pca_normals")
             else "autourdf_tpu_torch/csrc/optim.cu" if k == "epoch_update"
             else "autourdf_tpu_torch/csrc/knn.cu" for k in sources}
    kernels = []
    chain_shape = timing.pop("chain")
    resim_shape = timing.pop("resim")
    for kname, t in timing.items():
        by_path = {pname: p["counts"][kname] for pname, p in paths.items()}
        kernels.append({
            "name": kname, "route": "cuda", "source": files[kname],
            "replaces": sources[kname], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "shape": t["shape"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "device_ms": t["device_ms"],
            "kernel_device_ms": t.get("kernel_device_ms"), "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
        })
        if kname in chain_shape:
            kernels[-1]["at_chain_shape"] = chain_shape[kname]
        if kname in resim_shape:
            kernels[-1]["at_resim_shape"] = resim_shape[kname]
        for extra in ("skeleton_ms", "barrier_floor_ms", "at_eval_shape", "at_shapes",
                      "plain_device_ms", "kernels_a_call", "plain_kernels_a_call"):
            if extra in t:
                kernels[-1][extra] = t[extra]
        if kernels[-1]["launches"] < 1:
            _fail(f"kernel {kname} was launched on no path")
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in ("ms", "device_ms", "plain_ms", "bound_ms")) or \
                not (k["library_ms"] is None or math.isfinite(k["library_ms"])):
            _fail(f"non-finite measurement for {k['name']}")
    if len(kernels) != len(sources):
        _fail(f"the kernel line lists {len(kernels)} kernels, not {len(sources)}")
    if solvers:
        _fail(f"a path called PyTorch's solvers on the card: {solvers}")
    print("[5] no path after [3] called torch.linalg.svd, det or eigh on a CUDA tensor")
    print(f"[total] {time.time() - started:.1f} s")
    print(f"[5] card: {gpu_line}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
