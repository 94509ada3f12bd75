"""On the card: one short run of each cell through the command line, with
``correct`` true and the result as the last line."""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells run the port's CUDA kernels")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "4294967311", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["correct"] is True, last["checks"]
    assert last["device"]["platform"] == "gpu"
