#!/usr/bin/env python3
"""Tune the block parameters of the port's search kernels on the card
(autourdf_tpu_torch/csrc/knn.cu).

    python3 scripts/torch_knn_tune.py [--kernels nn nn_min_bidir] [--out knn_tune.json]

Builds the kernels, prints ptxas' registers and the SASS counts of the
sweeps' inner loops, checks every kernel exactly against its plain version
for every block shape it times, and prints the device time (torch.profiler)
of the search kernel alone and of the whole wrapper beside what ops/knn.py
plan_bidir picks, and for every shape and kernel the plan's time over the
best swept:

- the two indexed bidirectional kernels (``nn_bidir``, ``nn_bidir_acc``):
  rows per block x threads per block (x chunk width) at the registration's
  shape (S=5, N=M=4988, norm 1), the large-cloud shape (S=1, N=M=20000), the
  ICP path's batch (S=2, N=M=4988) and a ragged pair (S=5, N=4418, M=4985);
- the one-directional and the min-only kernel (``nn``, ``nn_min_bidir``):
  rows x threads at the ICP batch (S=100, N=M=4988), the
  carry test's shape (S=9, N=25600, M=2048) and S=5, N=M=4988; ``nn`` at
  norm 2 (what its paths ask for), ``nn_min_bidir`` at norm 1.

Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from autourdf_tpu_torch.ops import _cuda, knn  # noqa: E402

KERNELS = ("nn", "nn_min_bidir", "nn_bidir", "nn_bidir_acc")


def sweep_blocks(kernel: str, x, y, norm: int, candidates, sms: int, gpu_line: str,
                 rows_out: list) -> bool:
    """Time ``kernel`` on (x, y) under every (rows, cols, threads) of
    ``candidates`` that it takes and under its plan, each checked exactly
    against the plain version; print the table and the plan over the best."""
    S, N, M = x.shape[0], x.shape[1], y.shape[1]
    plain = {"nn": knn._nn_plain, "nn_min_bidir": knn._nn_min_bidir_plain}.get(
        kernel, knn._nn_bidir_plain)
    ref = plain(x, y, norm)
    picked = knn.plan_bidir(S, N, M, sms, kernel)
    print(f"{kernel} S={S} N={N} M={M} norm={norm}: plan_bidir picks {picked}")
    timed = []
    for rows, cols, threads in sorted(set(candidates) | {(picked.rows, picked.cols,
                                                          picked.threads)}):
        plan = knn.make_plan(S, N, M, sms, kernel, rows, cols, threads)
        if plan is None:
            continue
        got = knn._launch_sweep(x, y, norm, plan)
        exact = all(torch.equal(a, b) for a, b in zip(got, ref, strict=True))
        by = chip_smoke._device_ms_by_kernel(lambda: knn._launch_sweep(x, y, norm, plan),
                                             reps=5 if S >= 100 else 10)
        rec = {"kernel": kernel, "S": S, "N": N, "M": M, "norm": norm, "rows": rows,
               "cols": cols, "threads": threads, "blocks": plan.blocks,
               "resident": plan.resident, "shared_bytes": plan.shared_bytes, "exact": exact,
               "sweep_ms": chip_smoke._sweep_ms(by, kernel),
               "wrapper_device_ms": sum(by.values()), "card": gpu_line,
               "planned": plan == picked}
        rows_out.append(rec)
        timed.append(rec)
        print(f"  rows {rows:3d} cols {cols:5d} threads {threads:3d} blocks {plan.blocks:5d} "
              f"({plan.blocks / sms:6.2f}/SM, resident {plan.resident}) shared "
              f"{plan.shared_bytes:6d}: sweep {rec['sweep_ms']:.4f} ms, wrapper device "
              f"{rec['wrapper_device_ms']:.4f} ms, exact {exact}"
              + ("   <- plan" if plan == picked else ""))
        if not exact:
            return False
    mine = next(r for r in timed if r["planned"])
    best = min(timed, key=lambda r: r["wrapper_device_ms"])
    print(f"  plan against best, {kernel} S={S} N={N} M={M}: plan "
          f"{mine['wrapper_device_ms']:.4f} ms (rows {mine['rows']}, cols {mine['cols']}, "
          f"threads {mine['threads']}), best {best['wrapper_device_ms']:.4f} ms (rows "
          f"{best['rows']}, cols {best['cols']}, threads {best['threads']}), plan / best "
          f"{mine['wrapper_device_ms'] / best['wrapper_device_ms']:.3f}")
    return True


def sweep_light(dev, gpu_line: str, sms: int, kernels, args, rows_out: list) -> bool:
    """rows x threads for the light_sweep kernels at the ICP batch, the carry
    test's shape and S=5, N=M=4988."""
    shapes = ((100, 4988, 4988), (9, 25600, 2048), (5, 4988, 4988)) if kernels else ()
    for si, (S, N, M) in enumerate(shapes):
        x, y = chip_smoke._case(np.random.default_rng(1), S, N, M, dev, si != 1)
        for kernel in kernels:
            cols = knn._chunk_cols(M, kernel)
            candidates = [(r, cols, t) for t in args.light_threads for r in args.light_rows]
            if not sweep_blocks(kernel, x, y, 2 if kernel == "nn" else 1, candidates, sms,
                                gpu_line, rows_out):
                return False
        del x, y
        torch.cuda.empty_cache()
    return True


def sweep_indexed(dev, gpu_line: str, sms: int, kernels, args, rows_out: list) -> bool:
    """rows x threads (x chunk width) for the two indexed bidirectional kernels
    at the registration's shape, the large clouds, the two-sequence batch of
    the ICP path and a ragged pair (N != M, neither a multiple of a block)."""
    shapes = (((5, 4988, 4988), (1, 20000, 20000), (2, 4988, 4988), (5, 4418, 4985))
              if kernels else ())
    for si, (S, N, M) in enumerate(shapes):
        x, y = chip_smoke._case(np.random.default_rng(1), S, N, M, dev, si < 2)
        for kernel in kernels:
            # chunk widths are swept at the first two shapes only
            chunk_cols = args.chunk_cols if kernel == "nn_bidir_acc" and si < 2 else []
            col_choices = sorted({knn._chunk_cols(M, kernel)}
                                 | {-(-M // -(-M // c)) + 3 & ~3 for c in chunk_cols})
            candidates = [(r, c, t) for c in col_choices for t in args.threads
                          for r in args.rows]
            if not sweep_blocks(kernel, x, y, 1, candidates, sms, gpu_line, rows_out):
                return False
    return True


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the measurements here as JSON")
    ap.add_argument("--kernels", nargs="*", default=list(KERNELS), choices=KERNELS)
    ap.add_argument("--chunk-cols", type=int, nargs="*", default=[2560, 5120, 10240])
    ap.add_argument("--threads", type=int, nargs="*", default=[128, 256, 512])
    ap.add_argument("--rows", type=int, nargs="*", default=[32, 64, 96, 128, 160, 192, 224, 256])
    ap.add_argument("--light-threads", type=int, nargs="*", default=[32, 64, 128, 256])
    ap.add_argument("--light-rows", type=int, nargs="*", default=[32, 64, 96, 128, 160, 192, 256, 384, 512])
    ap.add_argument("--sass", default=None, help="write the L1 per-tile kernel's SASS here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(gpu_line)
    _cuda.library("knn")
    for line in _cuda.build_logs.get("knn", "").splitlines():
        if "Function properties" in line or "Used" in line or "spill" in line:
            print(line.strip()[:160])
    so = _cuda.build("knn")
    for kname in chip_smoke.SASS_KERNELS:
        dump = args.sass if kname == "nn_bidir_kernelILi1E" else None
        print(f"SASS inner loop of {kname}: {chip_smoke.sass_inner_loop(so, kname, dump)}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the SM clock while the card is busy with the search
    xb, yb = chip_smoke._case(np.random.default_rng(0), 5, 4988, 4988, dev, True)
    for _ in range(3000):
        knn._nn_bidir_cuda(xb, yb, 1)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.cuda.synchronize()
    print(f"SM clock, its maximum and the power draw under 3,000 queued searches: {clocks}")
    del xb, yb
    rows_out = []
    ok = sweep_light(dev, gpu_line, sms, [k for k in args.kernels if k in knn._LIGHT_KERNELS],
                     args, rows_out)
    ok = ok and sweep_indexed(dev, gpu_line, sms,
                              [k for k in args.kernels if k in knn._INDEXED_KERNELS], args,
                              rows_out)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows_out, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
