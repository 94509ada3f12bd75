"""Run one cell of the benchmark of ``autourdf_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card.  Set-up
(imports, the kernels' build on a fresh checkout, the cell's inputs and one
warm unit) is timed as ``setup_s``; then units run back to back for
``--seconds`` and the last unit is finished.  With ``--trace 0`` the result
line carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a profiled slice of the window.  Outputs are then held
against the plain reference under ``benchmark/reference/``.  The last line of
standard output is the result as one JSON object.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    return harness.main(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                        PROCESS_START)


if __name__ == "__main__":
    sys.exit(main())
