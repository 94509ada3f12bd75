"""The port's spans and program counters (``autourdf_tpu_torch/utils/
telemetry.py``, ``utils/programs.py``) on the CPU: off, a span is one shared
no-op and a registration records nothing; on, a registration's spans form one
tree a call whose children lie within their parents; the stage record's
``seconds`` times the stage's work; the program cache counts what it drops;
and under ``torch.profiler`` a span is a host range around its operations,
not a user annotation."""

import json
import os

import numpy as np
import pytest
import torch

from autourdf_tpu_torch import cli, workflow
from autourdf_tpu_torch.config import PipelineConfig
from autourdf_tpu_torch.io.ply import write_ply
from autourdf_tpu_torch.utils import programs, telemetry

K = 4
NAMES = {"register", "register.read_frames", "register.segment_init", "register.draw_weights",
         "register.phase", "register.resample", "register.readback",
         "register.write_artifacts", "program.replay"}


@pytest.fixture(autouse=True)
def _spans_left_off():
    telemetry.enable(False)
    telemetry.collect()
    yield
    telemetry.enable(False)
    telemetry.collect()


@pytest.fixture
def cfg(tmp_path):
    """Two ragged sequences of three frames in the real-scan layout."""
    rng = np.random.default_rng(5)
    root = tmp_path / "data"
    for s in range(2):
        for t in range(3):
            pts = rng.uniform(-0.2, 0.2, (150 + 10 * s + 5 * t, 3)).astype(np.float32)
            write_ply(str(root / "raw" / "wx200_real_5" / f"V{s:04}" / f"{t:04}" / "robot.ply"),
                      pts)
    return PipelineConfig(robot="wx200_real_5", data_root=str(root), num_videos=2, num_seg=K,
                          epochs=4)


def _register(cfg):
    return workflow.run_registration(cfg, verbose=False, device="cpu")


def _records(cfg):
    with open(os.path.join(cfg.data_root, "telemetry.json")) as f:
        return json.load(f)


def test_spans_off_are_one_no_op_and_record_nothing(cfg):
    assert telemetry.span("a") is telemetry.span("b", device=True, pair=1)
    with telemetry.span("c") as sp:
        sp.note(nodes=3)
    _register(cfg)
    assert telemetry.collect() == []
    (rec,) = _records(cfg)
    assert rec["stage"] == "register" and rec["seconds"] > 0
    assert "spans" not in rec and "programs" not in rec


def test_span_tree_of_a_registration(cfg):
    telemetry.enable()
    _register(cfg)
    _register(cfg)
    spans = telemetry.collect()
    assert telemetry.collect() == []
    roots = [i for i, sp in enumerate(spans) if sp["parent"] is None]
    assert [spans[i]["name"] for i in roots] == ["register", "register"]
    assert spans[roots[0]]["attrs"] == {"S": 2, "T": 3, "N": 170}
    assert {sp["name"] for sp in spans} == NAMES
    for sp in spans:
        if sp["parent"] is not None:
            parent = spans[sp["parent"]]
            assert parent["start_ns"] <= sp["start_ns"] <= sp["end_ns"] <= parent["end_ns"]
        assert "device_start_ms" not in sp            # nothing is timed on the CPU
    phases = [sp for sp in spans if sp["name"] == "register.phase"]
    assert all(spans[sp["parent"]]["name"] == "register" for sp in phases)
    assert [(sp["attrs"]["pair"], sp["attrs"]["kind"]) for sp in phases[:4]] == [
        (0, "step"), (0, "anchor"), (1, "step"), (1, "anchor")]
    replays = [sp for sp in spans if sp["name"] == "program.replay"]
    assert {spans[sp["parent"]]["name"] for sp in replays} == {"register.phase",
                                                               "register.resample"}
    assert {sp["attrs"]["family"] for sp in replays} == {"train_init", "train_epochs",
                                                         "resample"}


def test_stage_record_times_the_stage(cfg):
    telemetry.enable()
    _register(cfg)
    (rec,) = _records(cfg)
    spans = rec["spans"]
    io = spans["register.read_frames"]["host_s"] + spans["register.write_artifacts"]["host_s"]
    assert rec["seconds"] > 0 and rec["seconds"] >= round(io, 3)
    assert rec["frames"] == 2 * 2 and rec["seconds_compute"] > 0
    assert spans["register"]["count"] == 1 and spans["register.resample"]["count"] == 2
    assert spans["register.phase"]["count"] == 4 and spans["register"]["device_s"] is None
    # a start and one chunk program a phase, and a resample a pair
    assert rec["programs"] == {"warmups": 0, "captures": 0, "replays": 4 * 2 + 2,
                               "evictions": 0}


@pytest.mark.parametrize("trace", [False, True])
def test_cli_trace_switch(cfg, trace):
    argv = ["register", "--robot", "wx200_real_5", "--data-root", cfg.data_root,
            "--num-video", "2", "--num-seg", str(K), "--epochs", "4", "--device", "cpu"]
    assert cli.main(argv + ["--trace"] * trace) == 0
    assert telemetry._on is trace
    (rec,) = _records(cfg)
    assert rec["stage"] == "register" and rec["seconds"] > 0
    assert ("spans" in rec, "programs" in rec) == (trace, trace)
    if trace:
        assert set(rec["spans"]) == NAMES


def test_cache_counts_evictions():
    programs.clear()
    before = programs.counters["evictions"]
    for i in range(programs.CACHE_SIZE):
        programs.run(("eviction-test", i), lambda x: (x,), torch.zeros(1))
    assert programs.counters["evictions"] == before
    for i in range(3):
        programs.run(("eviction-test", programs.CACHE_SIZE + i), lambda x: (x,), torch.zeros(1))
        assert programs.counters["evictions"] == before + i + 1
    programs.clear()


def test_span_is_a_host_range_in_the_profiler_trace():
    from torch.profiler import ProfilerActivity, profile

    telemetry.enable()
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("outer.span"):
            with telemetry.span("inner.span"):
                (a @ a).relu()
    raw = prof.profiler.kineto_results.events()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in raw]
    # an operator's range: the profiler mirrors a user annotation onto the
    # device, where it would read as busy time
    assert not any(e.is_user_annotation() for e in raw if e.name().endswith(".span"))
    (outer,) = [e for e in events if e[0] == "outer.span"]
    (inner,) = [e for e in events if e[0] == "inner.span"]
    ops = [e for e in events if e[0] in ("aten::mm", "aten::relu")]
    assert len(ops) == 2
    for _, s, e in [inner] + ops:
        assert outer[1] <= s <= e <= outer[2]
    for _, s, e in ops:
        assert inner[1] <= s <= e <= inner[2]
    assert [sp["name"] for sp in telemetry.collect()] == ["outer.span", "inner.span"]
