"""The harness finds every cell's files by name, and each cell runs at a
tiny size on the CPU through the result contract with ``correct`` true; a
new cell lands as new files and entries alone."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT, run_tiny

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_every_cell_has_a_tiny_size():
    """Each cell's own file gives its tiny sizes, which a real run never
    reads: its settings come from the cell's file without them, the
    traffic and the configuration."""
    from benchmark import harness

    for cell in CELLS:
        c = harness.find_cell(ROOT, cell)
        own = harness.load_json(os.path.join(ROOT, "benchmark", "cells", f"{cell}.json"))
        assert c.tiny and c.tiny == own["tiny"], cell
        run = harness.Run(cell=c, seed=1, device="cuda", tmp="", trace=False)
        assert run.setting("tiny") is None
        for key in c.tiny:
            assert run.setting(key) == next((src[key] for src in (c.own, c.traffic, c.config)
                                             if key in src), None)


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


def _digests(root) -> dict:
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_lands_as_new_files_and_entries(tmp_path):
    """A copy of the checkout gains a second cell of the register stage
    through new files (a configuration, a traffic mix, the cell's own file)
    and entries in BENCHMARK.json alone; the copy's own harness finds it,
    resolves its metrics and runs it tiny and correct, and no file the copy
    started with changes but BENCHMARK.json."""
    from benchmark import harness

    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for d in ("benchmark", "autourdf_tpu_torch"):
        shutil.copytree(os.path.join(ROOT, d), root / d,
                        ignore=shutil.ignore_patterns("__pycache__", "_build"))
    old = harness.find_cell(ROOT, "register.wx200_real")
    frames = old.config["frames"]["dir"]
    shutil.copytree(os.path.join(ROOT, frames), root / frames)
    before = _digests(root)

    name = "register.wx200_real_3"
    config = {**old.config, "name": "wx200_real_3", "sequences": 3}
    traffic = {**old.traffic, "check_phases": 3}
    own = {**old.own, "tiny": {"tiny_frames": [2, 2, 250], "epochs": 104, "num_seg": 3,
                               "check_phases": 2}}
    for path, obj in (("benchmark/configs/wx200_real_3.json", config),
                      ("benchmark/traffic/register_batch_3.json", traffic),
                      (f"benchmark/cells/{name}.json", own)):
        assert not (root / path).exists()
        (root / path).write_text(json.dumps(obj, indent=1))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({**old.config_entry, "name": "wx200_real_3",
                            "file": "benchmark/configs/wx200_real_3.json",
                            "reduced": ["sequences"]})
    spec["workloads"].append({"name": name, "config": "wx200_real_3",
                              "traffic": "register_batch_3", "chips": 1,
                              "why": "three of the five real scan sequences in one batch"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if old.name in m.get("workloads", ()):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))

    c = harness.find_cell(str(root), name)
    assert c.config["sequences"] == 3 and c.traffic["check_phases"] == 3
    assert c.tiny == own["tiny"] and "tiny" not in c.own
    assert [m["name"] for m in c.end_to_end()] == [m["name"] for m in old.end_to_end()]
    assert [m["name"] for m in c.per_layer()] == [m["name"] for m in old.per_layer()]
    for m in c.per_layer():
        assert harness.load_metric(str(root), m["name"])({"units": []}) is None

    # the copy's harness, stage and program (the harness refuses a program
    # from outside the checkout), as a run of the command would load them
    code = ("import json, sys, time\n"
            "sys.path.insert(0, '.')\n"
            "import torch\n"
            "torch.set_num_threads(4)\n"
            "from benchmark import harness\n"
            f"c = harness.find_cell('.', {name!r})\n"
            "r = harness.run_cell('.', c.name, 987654321012, 0.0, False, time.perf_counter(),\n"
            "                     device='cpu', overrides=c.tiny)\n"
            "print(json.dumps({'correct': r['correct'], 'checks': r['checks'],\n"
            "                  'metrics': sorted(r['metrics'])}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    r = json.loads(res.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    assert r["metrics"] == sorted(m["name"] for m in c.end_to_end())

    after = _digests(root)
    assert {p for p in before if after.get(p) != before[p]} == {"BENCHMARK.json"}
