#!/usr/bin/env python3
"""Tune the block parameters of the port's two indexed search kernels on the
card (autourdf_tpu_torch/csrc/knn.cu: nn_bidir_kernel, nn_bidir_acc_kernel).

    python3 scripts/torch_knn_tune.py [--out knn_tune.json]

Builds the kernels, prints ptxas' registers and the SASS counts of the
sweep's inner loop, checks both kernels exactly against the plain version
for every block shape it times, and prints the device time (torch.profiler)
of the search kernel alone and of the whole wrapper for rows per block x
threads per block at the registration's shape (S=5, N=M=4988, norm 1), the
large-cloud shape (S=1, N=M=20000), the ICP path's batch (S=2, N=M=4988) and
a ragged pair (S=5, N=4418, M=4985), beside what ops/knn.py plan_bidir
picks; for every shape and kernel it prints the plan's time over the best
swept.  Needs one NVIDIA GPU.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the measurements here as JSON")
    ap.add_argument("--chunk-cols", type=int, nargs="*", default=[2560, 5120, 10240])
    ap.add_argument("--threads", type=int, nargs="*", default=[128, 256, 512])
    ap.add_argument("--rows", type=int, nargs="*", default=[32, 64, 96, 128, 160, 192, 224, 256])
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
    for kname in ("nn_bidir_kernelILi1E", "nn_bidir_acc_kernelILi1E", "nn_bidir_kernelILi2E"):
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
    rows_out = []
    # the registration's shape, the large clouds, the two-sequence batch of
    # the ICP path and a ragged pair (N != M, neither a multiple of a block)
    shapes = ((5, 4988, 4988), (1, 20000, 20000), (2, 4988, 4988), (5, 4418, 4985))
    for si, (S, N, M) in enumerate(shapes):
        x, y = chip_smoke._case(np.random.default_rng(1), S, N, M, dev, si < 2)
        ref = knn._nn_bidir_plain(x, y, 1)
        for kernel in ("nn_bidir", "nn_bidir_acc"):
            picked = knn.plan_bidir(S, N, M, sms, kernel)
            print(f"{kernel} S={S} N={N} M={M}: plan_bidir picks {picked}")
            # chunk widths are swept at the first two shapes only
            chunk_cols = args.chunk_cols if kernel == "nn_bidir_acc" and si < 2 else []
            col_choices = sorted({knn._chunk_cols(M, kernel)}
                                 | {-(-M // -(-M // c)) + 3 & ~3 for c in chunk_cols})
            blocks = {(cols, threads, rows) for cols in col_choices for threads in args.threads
                      for rows in args.rows} | {(picked.cols, picked.threads, picked.rows)}
            timed = []
            for cols, threads, rows in sorted(blocks):
                plan = knn.make_plan(S, N, M, sms, kernel, rows, cols, threads)
                if plan is None:
                    continue
                got = knn._launch_sweep(x, y, 1, plan)
                exact = all(torch.equal(a, b) for a, b in zip(got, ref))
                by = chip_smoke._device_ms_by_kernel(
                    lambda: knn._launch_sweep(x, y, 1, plan), reps=10)
                rec = {"kernel": kernel, "S": S, "N": N, "M": M, "rows": rows,
                       "cols": cols, "threads": threads, "blocks": plan.blocks,
                       "resident": plan.resident, "shared_bytes": plan.shared_bytes,
                       "exact": exact, "sweep_ms": chip_smoke._sweep_ms(by),
                       "wrapper_device_ms": sum(by.values()), "card": gpu_line,
                       "planned": plan == picked}
                rows_out.append(rec)
                timed.append(rec)
                print(f"  rows {rows:3d} cols {cols:5d} threads {threads:3d} blocks "
                      f"{plan.blocks:5d} ({plan.blocks / sms:6.2f}/SM, resident "
                      f"{plan.resident}) shared {plan.shared_bytes:6d}: sweep "
                      f"{rec['sweep_ms']:.4f} ms, wrapper device "
                      f"{rec['wrapper_device_ms']:.4f} ms, exact {exact}"
                      + ("   <- plan" if plan == picked else ""))
                if not exact:
                    return 1
            mine = next(r for r in timed if r["planned"])
            best = min(timed, key=lambda r: r["wrapper_device_ms"])
            print(f"  plan against best, {kernel} S={S} N={N} M={M}: plan "
                  f"{mine['wrapper_device_ms']:.4f} ms (rows {mine['rows']}, cols {mine['cols']}, "
                  f"threads {mine['threads']}), best {best['wrapper_device_ms']:.4f} ms (rows "
                  f"{best['rows']}, cols {best['cols']}, threads {best['threads']}), plan / best "
                  f"{mine['wrapper_device_ms'] / best['wrapper_device_ms']:.3f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows_out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
