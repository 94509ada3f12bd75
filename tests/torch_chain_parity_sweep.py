"""Where the port's chain fit and the JAX package's part, on the CPU.

Both packages fit the inputs of ``test_torch_chain.py`` (the noisy hinge;
the wrist trap with registration error and ragged frames) and one JSON
object is printed a fit:

``--window 30,40,50``
    the hinge with each option of ``test_refine_chain_matches_jax_hinge``,
    fitted for each of these lengths: the largest relative gap of the
    per-step losses and the first step past 1e-5 relative (null if none).
``--long hinge|trap --steps N [--balance]``
    one fit of N steps (the stage's default is 1,200): the final
    geometry's gaps as ``test_torch_chain_long.py`` measures them.

Run from the repository root::

    JAX_PLATFORMS=cpu python tests/torch_chain_parity_sweep.py --window 30,40,45,50,55,60,70,80,100
    JAX_PLATFORMS=cpu python tests/torch_chain_parity_sweep.py --long trap --steps 1200
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
from test_torch_chain import (CPU, LOSS_RTOL, chain_geometry_gaps, coord_map_from_jax,  # noqa: E402
                              hinge_problem, jchain, port_joints, port_links, run_jax_chain,
                              tchain, trap_problem)

WINDOW_OPTIONS = (dict(), dict(balance=True), dict(canonical_frames=3), dict(anchor_step=2),
                  dict(trunc=2.0))


def problem(name):
    if name == "hinge":
        cms, links, joints, frames = hinge_problem()
        return cms, links, joints, frames, dict(points_per_link=256)
    cms, links, joints, frames, masks = trap_problem()
    return cms, links, joints, frames, dict(points_per_link=64, frame_masks=masks)


def fit_both(name, steps, record, **opts):
    cms, links, joints, frames, kw = problem(name)
    kw.update(opts, steps=steps)
    t0 = time.time()
    if record:
        jref, jres, jlosses = run_jax_chain(links, joints, cms, frames, **kw)
    else:
        (jref, jres), jlosses = jchain.refine_chain(links, joints, cms, frames, **kw), None
    t1 = time.time()
    tref, tres = tchain.refine_chain(port_links(links), port_joints(joints),
                                     [coord_map_from_jax(c) for c in cms], frames, device=CPU,
                                     **kw)
    out = dict(problem=name, opts=opts, steps=steps, jax_s=round(t1 - t0, 1),
               port_s=round(time.time() - t1, 1))
    return out, tres, jres, jlosses


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--window", help="comma-separated fit lengths on the hinge")
    ap.add_argument("--long", choices=("hinge", "trap"))
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--balance", action="store_true")
    args = ap.parse_args()
    if args.window:
        for opts in WINDOW_OPTIONS:
            for steps in (int(s) for s in args.window.split(",")):
                out, tres, _, jlosses = fit_both("hinge", steps, True, **opts)
                rel = np.abs(tres.step_losses - jlosses) / np.abs(jlosses)
                bad = np.nonzero(rel > LOSS_RTOL)[0]
                out.update(max_rel=float(rel.max()), first_step_past=int(bad[0]) if len(bad)
                           else None)
                print(json.dumps(out), flush=True)
    if args.long:
        opts = dict(balance=True) if args.balance else {}
        out, tres, jres, _ = fit_both(args.long, args.steps, False, **opts)
        out.update(chain_geometry_gaps(tres, jres))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
