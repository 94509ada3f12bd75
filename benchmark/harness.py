"""The cell runner of the benchmark.

A cell is found by name from files alone: its entry in ``BENCHMARK.json``,
the configuration file that entry names, the traffic mix
``benchmark/traffic/<traffic>.json``, the cell's own file
``benchmark/cells/<cell>.json`` (its check's limits, its traced slice and,
under ``tiny``, the sizes its CPU tests run it at), the stage module
``benchmark/stages/<stage>.py`` that the traffic names, and one reader
``benchmark/metrics/<metric>.py`` a per-layer metric.

Adding a cell edits no file that is there.  It adds files: the
configuration (``benchmark/configs/``, unless the cell shares one), the
cell's own file, the traffic file (unless it shares one) and, for a new
stage, the stage module and the readers of its metrics.  It adds entries to
``BENCHMARK.json``: the configuration, the workload, and the cell's name in
the ``workloads`` list of every metric it reports.  The CPU tests find the
new cell and its ``tiny`` sizes by themselves.

A run: set-up (the stage makes its inputs from the seed and runs one warm
unit), the window (units back to back until ``seconds`` have passed, then the
last unit is finished), the metrics, the check against the plain reference,
and the result line.  A traced run also turns the program's spans on for the
window and hands them, with its program counters, to the readers.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

# Top-level module names that no process of the benchmark may hold.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "autourdf_tpu")


class BenchmarkError(RuntimeError):
    """A run that cannot give a result (no card, a missing file, a fault)."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """Everything a run of one cell reads, found by the cell's name."""
    root: str
    name: str
    entry: dict        # the cell's entry in BENCHMARK.json
    spec: dict         # the whole BENCHMARK.json
    config_entry: dict
    config: dict       # the configuration file
    traffic: dict      # benchmark/traffic/<traffic>.json
    own: dict          # benchmark/cells/<cell>.json, without ``tiny``
    tiny: dict | None  # its ``tiny``: the CPU tests' overrides, never a real run's

    def end_to_end(self) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list[dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]


def find_cell(root: str, name: str) -> Cell:
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise BenchmarkError(f"no cell {name!r} in BENCHMARK.json")
    config_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    bench = os.path.join(root, "benchmark")
    own = load_json(os.path.join(bench, "cells", f"{name}.json"))
    tiny = own.pop("tiny", None)
    return Cell(root=root, name=name, entry=entry, spec=spec, config_entry=config_entry,
                config=load_json(os.path.join(root, config_entry["file"])),
                traffic=load_json(os.path.join(bench, "traffic", f"{entry['traffic']}.json")),
                own=own, tiny=tiny)


def load_stage(kind: str):
    """The stage module ``benchmark/stages/<kind>.py``."""
    return importlib.import_module(f"benchmark.stages.{kind}")


def load_metric(root: str, name: str):
    """The reader ``benchmark/metrics/<name>.py`` of a per-layer metric: its
    ``read(data)`` returns the value, or None where the run has nothing to
    read."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def unit_seed(seed: int, i: int) -> int:
    """The seed of unit ``i`` of a run (``i = -1``: the warm unit), drawn from
    the run's ``--seed``; any whole number is taken."""
    words = [abs(int(seed)) % (1 << 64), int(seed < 0), i + 1]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint32)[0])


def merge_max(into: dict, *dicts, **values) -> dict:
    """``into`` with each value raised to the largest given under its name."""
    for d in dicts + (values,):
        for k, v in d.items():
            into[k] = max(into.get(k, v), v)
    return into


def forbidden_modules() -> list[str]:
    """Modules in this process whose top-level name is forbidden, compared
    whole (``autourdf_tpu_torch`` is not ``autourdf_tpu``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


@dataclass
class Check:
    """One number compared against its limit (held when ``value <= limit``)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value) and self.value <= self.limit)


@dataclass
class Run:
    """What a stage gets: the cell, the run's seed, device and scratch
    directory, whether the window is traced, and test-only overrides."""
    cell: Cell
    seed: int
    device: str
    tmp: str
    trace: bool
    overrides: dict = field(default_factory=dict)
    data: dict = field(default_factory=dict)   # what the traced run hands the readers

    def setting(self, key: str, default=None):
        """A value of the cell's own file, the traffic or the configuration,
        in that order, unless a test overrides it."""
        if key in self.overrides:
            return self.overrides[key]
        for src in (self.cell.own, self.cell.traffic, self.cell.config):
            if key in src:
                return src[key]
        return default


def _device_info(device: str, chips: int) -> dict:
    import torch

    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                         for d in range(chips))}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def _start_device(device: str) -> float:
    """Start CUDA (the context, the allocator) and return the time."""
    import torch

    if device == "cuda":
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    return time.perf_counter()


def _load_libraries(device: str) -> None:
    """Load (on a fresh checkout: build) the port's kernel libraries and its
    native host library, which the first unit would otherwise build."""
    from autourdf_tpu_torch.io import native

    native.available()
    if device == "cuda":
        from autourdf_tpu_torch.ops import _cuda

        _cuda.library("knn")
        _cuda.library("geom")
        _cuda.library("optim")


@contextlib.contextmanager
def _spans_on(on: bool):
    """The program's spans on while a traced run's set-up and window run."""
    if not on:
        yield
        return
    from autourdf_tpu_torch.utils import telemetry

    telemetry.enable(True)
    try:
        yield
    finally:
        telemetry.enable(False)


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             process_start: float, device: str = "cuda", overrides: dict | None = None,
             program_context=None) -> dict:
    """One run of cell ``name``; returns the result object.  ``device="cpu"``
    and ``overrides`` are for the CPU tests, which run a cell at a tiny size.
    ``program_context``, a context manager, is entered around the set-up and
    the window and left before the check: the control's lower precision or
    a planted fault (``benchmark/control.py``)."""
    cell = find_cell(root, name)
    chips = int(cell.entry["chips"])
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise BenchmarkError("torch.cuda.is_available() is False: no card to run on")
        if torch.cuda.device_count() < chips:
            raise BenchmarkError(f"the cell needs {chips} cards, "
                                 f"{torch.cuda.device_count()} are present")
    import autourdf_tpu_torch

    where = os.path.dirname(os.path.abspath(autourdf_tpu_torch.__file__))
    if os.path.commonpath([where, os.path.abspath(root)]) != os.path.abspath(root):
        raise BenchmarkError(f"the program is not this checkout's: {where}")
    tmp = tempfile.mkdtemp(prefix="autourdf_bench_")
    try:
        run = Run(cell=cell, seed=seed, device=device, tmp=tmp, trace=trace,
                  overrides=dict(overrides or {}))
        stage = load_stage(cell.traffic["stage"]).Stage(run)
        from autourdf_tpu_torch.utils import programs, telemetry

        with program_context or contextlib.nullcontext(), _spans_on(trace):
            split = {"process, imports and CUDA start": _start_device(device) - process_start}
            t = time.perf_counter()
            _load_libraries(device)
            split["kernel libraries (built on a fresh checkout)"] = time.perf_counter() - t
            split.update(stage.setup())
            setup_s = time.perf_counter() - process_start
            print("setup split: " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()),
                  file=sys.stderr, flush=True)
            if trace:
                telemetry.collect()             # the warm unit's spans
            units = []
            t0 = time.perf_counter()
            while True:
                units.append(stage.unit(len(units)))
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
            if trace:
                run.data["spans"] = telemetry.collect()
                run.data["programs"] = dict(programs.counters)
        print("units: " + " ".join(f"{u['seconds']:.3f}" for u in units) + " s",
              file=sys.stderr, flush=True)

        found = forbidden_modules()
        if found:
            raise BenchmarkError(f"forbidden modules loaded: {', '.join(found)}")
        dev_info = _device_info(device, chips)

        metrics: dict = {}
        if trace:
            run.data.update(units=units, window_s=window_s)
            for m in cell.per_layer():
                value = load_metric(root, m["name"])(run.data)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            sl = run.data.get("slice")
            if sl is None:
                raise BenchmarkError("the traced run profiled no slice")
            dev_info.update(busy_s=sl["busy_s"], window_s=sl["wall_s"])
            from .trace import breakdown

            span_names = {s["name"] for s in run.data["spans"]}
        else:
            values = stage.end_to_end(units, window_s)
            values["setup_s"] = setup_s
            for m in cell.end_to_end():
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

        stage.release()
        # the stage's readings; those the cell's file gives a limit are
        # compared, the others printed (they do not separate sound runs
        # from the control)
        readings, per_unit = stage.check()
        limits = run.setting("limits")
        checks = [Check(n, readings[n], lim) for n, lim in limits.items()]
        for n, v in readings.items():
            if n not in limits:
                print(f"reading {n} {v!r} (not compared)", file=sys.stderr, flush=True)
        failed = sum(any(not Check(n, v, limits[n]).ok for n, v in rd.items() if n in limits)
                     for rd in per_unit.values())
        result = {
            "correct": all(c.ok for c in checks),
            "attempted": len(units),
            "failed": failed,
            "metrics": metrics,
            "device": dev_info,
        }
        if trace:
            result["breakdown"] = breakdown(sl, span_names)
        result["readings"] = readings    # every reading; not printed in the result line
        result["checks"] = {c.name: {"value": float(c.value), "limit": float(c.limit)}
                            for c in checks}
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(root: str, name: str, seed: int, seconds: float, trace: bool,
         process_start: float) -> int:
    """The command line's run: prints progress and the compared numbers on
    standard error, the result as the last line of standard output."""
    try:
        result = run_cell(root, name, seed, seconds, trace, process_start)
    except Exception:  # noqa: BLE001 - the run's boundary: report, print no result
        traceback.print_exc()
        print("benchmark: no result", file=sys.stderr, flush=True)
        return 1
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 1
    result.pop("readings")
    for cname, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {cname} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
