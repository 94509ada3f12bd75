"""The readers of the program's capture records, on hand-built records (a
warm unit's and two window units') and on a traced tiny CPU run."""

import time

import pytest

from conftest import ROOT, TINY

from benchmark import harness


def _records():
    """The warm unit's captures (two families warmed up, 0.2 + 0.1 s) and
    two window units', which find their families warm."""
    warm = [{"name": "train_init", "nodes": 40, "epochs": None, "warm_s": 0.2},
            {"name": "train_epochs", "nodes": 38800, "epochs": 100, "warm_s": 0.1}]
    one = [{"name": "train_epochs", "nodes": 38800, "epochs": 100, "warm_s": 0.0},
           {"name": "resample", "nodes": 700, "epochs": None, "warm_s": 0.0}]
    two = [{"name": "train_epochs", "nodes": 39000, "epochs": 100, "warm_s": 0.0}]
    return warm + one + two, {"units": [{"captures": one}, {"captures": two}]}


@pytest.mark.parametrize("metric,want", [
    ("register.warmup_s", 0.3),
    ("register.kernels_per_epoch", (388 + 390) / 2),
])
def test_reader_on_hand_built_records(metric, want, monkeypatch):
    from autourdf_tpu_torch.utils import programs

    records, data = _records()
    monkeypatch.setattr(programs, "captures", records)
    read = harness.load_metric(ROOT, metric)
    assert read(data) == pytest.approx(want, rel=1e-9)
    monkeypatch.setattr(programs, "captures", [])
    assert read({"units": []}) is None


@pytest.mark.parametrize("metric", ["register.warmup_s", "register.kernels_per_epoch"])
def test_reader_on_records_without_the_new_keys(metric, monkeypatch):
    """A program whose capture records lack ``warm_s`` and ``epochs`` gives
    no reading, and the reader does not raise."""
    from autourdf_tpu_torch.utils import programs

    records, data = _records()
    for c in records:
        del c["warm_s"], c["epochs"]
    monkeypatch.setattr(programs, "captures", records)
    assert harness.load_metric(ROOT, metric)(data) is None


def test_traced_tiny_run_leaves_the_spans_off():
    """On the CPU no program is captured, so both readers find nothing, and
    no span is timed on the device; the host's spans of the window reach
    the readers.  The traced run stays correct and leaves the program's
    spans off."""
    cell = "register.wx200_real"
    r = harness.run_cell(ROOT, cell, 123456789012, 0.0, True, time.perf_counter(),
                         device="cpu",
                         overrides={**TINY[cell], "trace": {"unit": 0, "phase": 1}})
    assert r["correct"] is True, r["checks"]
    for name in ("register.warmup_s", "register.kernels_per_epoch",
                 "register.unit_device_idle", "register.segment_init_ms",
                 "register.resample_ms"):
        assert name not in r["metrics"]
    assert r["metrics"]["register.host_io_s"]["value"] > 0
    from autourdf_tpu_torch.utils import telemetry

    assert not telemetry._on and telemetry.collect() == []


def test_untraced_tiny_run_leaves_the_spans_off(monkeypatch):
    """An untraced run never turns the program's spans on."""
    from autourdf_tpu_torch.utils import telemetry

    calls = []
    monkeypatch.setattr(telemetry, "enable", lambda on=True: calls.append(on))
    r = harness.run_cell(ROOT, "register.wx200_real", 123456789013, 0.0, False,
                         time.perf_counter(), device="cpu", overrides=TINY["register.wx200_real"])
    assert r["correct"] is True, r["checks"]
    assert calls == [] and not telemetry._on
