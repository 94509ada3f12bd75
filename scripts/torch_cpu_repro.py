#!/usr/bin/env python3
"""Whether the port's CPU registration is the same run to run, at the real
scans' size, operation by operation.

    python3 scripts/torch_cpu_repro.py [--tree DIR] [--epochs 40]

``--tree`` is the root of the checkout whose ``autourdf_tpu_torch`` is
measured (default: this one); the scans and the record come from this
checkout.  On the CPU, at the default intra-op threads:

1. the step phase of frame pair 0->1 of ``data_real/raw/wx200_real_5`` (5
   sequences, K=20, hidden 512) from the init of
   ``tests/data/same_draw_wx200_real_5_seed0.npz`` and
   ``workflow._draw_weights(5, 0)``, ``--epochs`` epochs, twice in one
   process: whether the loss histories are equal, and their largest gap;
2. each operation of the first epoch twice on the same inputs: the MLP
   forward, the one-hot selection, the Chamfer value, then the backward of
   each (the Chamfer's, the selection's and the MLP's, the second time on
   the first time's upstream gradient): which are equal bit for bit.

Prints one JSON line.  Takes about a minute at 40 epochs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, "tests", "data", "same_draw_wx200_real_5_seed0.npz")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--epochs", type=int, default=40)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    from autourdf_tpu_torch.ops.chamfer import chamfer_distance
    from autourdf_tpu_torch.registration import SegmentInit
    from autourdf_tpu_torch.registration import optimizer as opt
    from autourdf_tpu_torch.workflow import _draw_weights, load_raw_sequences_padded

    rec = np.load(RECORD)
    _, frames, masks = load_raw_sequences_padded(
        os.path.join(REPO, "data_real", "raw", "wx200_real_5"), 5)
    init = SegmentInit(*(torch.from_numpy(rec[k]) for k in ("init_matrices", "init_points")),
                       torch.from_numpy(rec["init_labels"].astype(np.int64)),
                       torch.from_numpy(rec["init_mask"]))
    model, sp, _ = _draw_weights(5, 0, "cpu")
    S = frames.shape[0]

    def tile(x):
        return x[None].expand((S,) + x.shape).contiguous()

    m0, pts, lab, pm = (tile(v) for v in init)
    target, tmask = torch.from_numpy(frames[:, 1]), torch.from_numpy(masks[:, 1])

    def phase():
        return opt.train_pose_mlp(model, model.flat_params(sp), m0, target, pts, lab, tmask, pm,
                                  epochs=args.epochs).loss_history

    a, b = phase(), phase()

    def epoch_ops(upstream=None):
        """The first epoch's operations; each backward on ``upstream``'s
        gradient from the operation after it, where given."""
        theta = model.flat_params(sp).clone().requires_grad_(True)
        with torch.enable_grad():
            m2 = model.forward_flat(theta, m0)
            m2d = m2.detach().requires_grad_(True)
            pred = opt.transform_by_labels(m2d, pts, lab)
            predd = pred.detach().requires_grad_(True)
            loss = chamfer_distance(predd, target, pm, tmask, norm=1)
            (g_pred,) = torch.autograd.grad(loss.sum(), predd)
            up = upstream or {"chamfer_backward": g_pred}
            (g_m2,) = torch.autograd.grad(pred, m2d, up["chamfer_backward"])
            up = upstream or {"selection_backward": g_m2}
            (g_theta,) = torch.autograd.grad(m2, theta, up["selection_backward"])
        return {"forward": m2, "selection": pred, "chamfer": loss, "chamfer_backward": g_pred,
                "selection_backward": g_m2, "mlp_backward": g_theta}

    first = epoch_ops()
    second = epoch_ops(first)
    print(json.dumps({
        "tree": os.path.abspath(args.tree), "threads": torch.get_num_threads(),
        "epochs": args.epochs, "phase_histories_equal": bool(torch.equal(a, b)),
        "phase_largest_gap": float((a - b).abs().max()),
        "operations_equal": {k: bool(torch.equal(first[k].detach(), second[k].detach()))
                             for k in first}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
