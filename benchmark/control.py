"""The control and the planted faults that the check has to catch, and the
command that reads their numbers on the card.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 --seconds 10 \\
        [--fault none|lower_precision|state_unchanged|half_batch|answer_altered ...]

runs the cell (set-up, a short window, the check) once a seed and a fault
given, in one process, with the program switched into the control or the
fault (``none``: as it is), and prints each run's readings.  The
benchmark's own runs never run this.

- ``lower_precision``: the program computes its float32 products in TF32,
  the precision below the configuration's float32 with TF32 off.  On the
  card that is PyTorch's own switch, which the port turns off when it is
  imported; on the CPU, which has no TF32, every matrix product's operands
  are rounded to TF32's 10-bit mantissa.
- ``state_unchanged``: the epoch's update (``optimizer.epoch_update``: the
  kernel on the card, the plain chain on the CPU) hands back the carry's
  parameters unchanged.
- ``half_batch``: each loss is taken over the first half of the posed points.
- ``answer_altered``: a result is changed where it is produced (a fit's
  best pose moved by a millimetre).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, round to nearest), with the
    gradient passed straight through."""
    if x.dtype != torch.float32:
        return x
    bits = x.detach().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


@contextlib.contextmanager
def _patched(pairs):
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in pairs]
    try:
        for obj, name, fn in pairs:
            setattr(obj, name, fn)
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


@contextlib.contextmanager
def lower_precision(device: str):
    import autourdf_tpu_torch  # noqa: F401 - its import turns TF32 off

    if device == "cuda":
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
        return
    mm, bmm, baddbmm, tmm = torch.matmul, torch.bmm, torch.baddbmm, torch.Tensor.__matmul__
    with _patched([
        (torch, "matmul", lambda a, b, **k: mm(_tf32(a), _tf32(b), **k)),
        (torch, "bmm", lambda a, b, **k: bmm(_tf32(a), _tf32(b), **k)),
        (torch, "baddbmm", lambda c, a, b, **k: baddbmm(c, _tf32(a), _tf32(b), **k)),
        (torch.Tensor, "__matmul__", lambda a, b: tmm(_tf32(a), _tf32(b))),
    ]):
        yield


@contextlib.contextmanager
def state_unchanged(device: str):
    from autourdf_tpu_torch.registration import optimizer

    update = optimizer.epoch_update

    def frozen(c, *a, **k):
        out, loss = update(c, *a, **k)
        return out._replace(theta=c.theta.clone()), loss

    with _patched([(optimizer, "epoch_update", frozen)]):
        yield


@contextlib.contextmanager
def half_batch(device: str):
    from autourdf_tpu_torch.registration import optimizer

    def halve(fn):
        def call(x, y, xm=None, ym=None, norm=1):
            n = x.shape[-2] // 2
            return fn(x[..., :n, :], y, None if xm is None else xm[..., :n], ym, norm=norm)
        return call

    with _patched([(optimizer, "chamfer_distance", halve(optimizer.chamfer_distance))]):
        yield


@contextlib.contextmanager
def answer_altered(device: str):
    from autourdf_tpu_torch.registration import optimizer

    finalize = optimizer.train_finalize

    def moved(carry, losses):
        res = finalize(carry, losses)
        best = res.best_matrices.clone()
        best[:, 0, 0, 3] += 1e-3
        return res._replace(best_matrices=best)

    with _patched([(optimizer, "train_finalize", moved)]):
        yield


KINDS = {"lower_precision": lower_precision, "state_unchanged": state_unchanged,
         "half_batch": half_batch, "answer_altered": answer_altered}


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description="read the control's or a fault's numbers")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault", nargs="+", default=["lower_precision"],
                    choices=sorted(KINDS) + ["none"])
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    for fault in args.fault:
        for seed in args.seeds:
            ctx = None if fault == "none" else KINDS[fault]("cuda")
            r = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                                 time.perf_counter(), program_context=ctx)
            print(json.dumps({"workload": args.workload, "fault": fault, "seed": seed,
                              "correct": r["correct"], "attempted": r["attempted"],
                              "checks": {k: v["value"] for k, v in r["checks"].items()},
                              "readings": r["readings"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
