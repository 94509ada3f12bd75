"""The harness finds every cell's files by name, and each cell runs at a
tiny size on the CPU through the result contract with ``correct`` true."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, TINY, run_tiny

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_every_cell_has_a_tiny_size():
    assert set(CELLS) <= set(TINY)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_from_files(cell):
    from benchmark import harness

    c = harness.find_cell(ROOT, cell)
    assert c.config["name"] == c.entry["config"]
    assert harness.load_stage(c.traffic["stage"]).Stage
    names = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in names and len(names) >= 2
    layer = c.per_layer()
    assert layer and all(m["moves"] in names for m in layer)
    for m in layer:
        assert harness.load_metric(ROOT, m["name"])({"units": []}) is None


def test_metrics_and_configs_are_files_of_their_own():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for m in SPEC["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
    for w in SPEC["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "cells", f"{w['name']}.json"))
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic",
                                           f"{w['traffic']}.json"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_tiny_and_correct(cell):
    r = run_tiny(cell)
    assert r["correct"] is True, r["checks"]
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["attempted"] >= 1 and r["failed"] == 0
    from benchmark import harness

    want = {m["name"] for m in harness.find_cell(ROOT, cell).end_to_end()}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    json.dumps(r)


def test_command_without_a_card_prints_no_result():
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "register.wx200_real", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_command_without_the_program_prints_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "register.wx200_real", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
