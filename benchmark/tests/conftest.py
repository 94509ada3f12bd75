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

# A cell at a size a CPU test holds: a few frames of a few hundred points,
# and epochs enough for a second epoch program (a chunk is 100 epochs).
TINY = {
    "register.wx200_real": {"tiny_frames": [2, 2, 300], "epochs": 104, "num_seg": 4,
                            "check_phases": 2},
}


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(old)


def run_tiny(cell: str, seed: int = 123456789012, trace: bool = False, context=None) -> dict:
    from benchmark import harness

    return harness.run_cell(ROOT, cell, seed, 0.0, trace, time.perf_counter(), device="cpu",
                            overrides=TINY[cell], program_context=context)
