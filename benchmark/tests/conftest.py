"""Shared helpers of the benchmark's CPU tests (``python -m pytest
benchmark/tests``): each cell at a tiny size on the CPU, with the port's
plain PyTorch paths."""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

CELLS = [w["name"] for w in harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]

# Each cell at a size a CPU test holds, from the ``tiny`` object of its own
# file (for the register cells: a few frames of a few hundred points, and
# epochs enough for a second epoch program, a chunk being 100 epochs).
TINY = {cell: harness.find_cell(ROOT, cell).tiny for cell in CELLS}


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(old)


def run_tiny(cell: str, seed: int = 123456789012, trace: bool = False, context=None) -> dict:
    return harness.run_cell(ROOT, cell, seed, 0.0, trace, time.perf_counter(), device="cpu",
                            overrides=TINY[cell], program_context=context)
