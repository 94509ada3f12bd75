"""A profiled slice of a run, the program's spans of a traced window, and
what the per-layer readers take from them.

``DeviceSlice`` runs ``torch.profiler`` around a bounded part of one unit and
reduces the trace to: every device operation's name and interval (kernels,
memory copies and sets; a user annotation that the profiler mirrors onto
the device is no work, and goes with the host's events), the device's busy
seconds (the union of those intervals), the slice's wall seconds on the
host clock, the device operations that took most time, and the ten longest
idle gaps with the host events that span each.  ``breakdown`` names each
gap by the innermost of them and by the innermost program span among them.

``units_of`` cuts the spans that ``utils/telemetry.py collect`` returns into
the window's units, by their root span.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: list[tuple[float, float]], lo: float, hi: float):
    """The gaps in ``[lo, hi]`` that no interval covers: ``(start, end)``."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


class DeviceSlice:
    """``start()`` / ``stop()`` around a slice of a unit; ``result`` is the
    reduction, with times in seconds."""

    def __init__(self, device: str, label: str):
        self.device = device
        self.label = label
        self.result: dict | None = None
        self._prof = None
        self._t0 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        _sync(self.device)
        self._prof = profile(activities=acts)
        self._prof.start()
        _sync(self.device)
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        _sync(self.device)
        wall = time.perf_counter() - self._t0
        self._prof.stop()
        self.result = reduce_events(self._prof.profiler.kineto_results.events(), self.label,
                                    wall)
        self._prof = None
        return self.result


def reduce_events(events, label: str, wall: float) -> dict:
    """The slice's reduction from the profiler's raw events (building its
    FunctionEvents for a whole URDF build's some 10^6 events takes
    minutes)."""
    kernels, host = [], []
    annotations = 0.0
    for e in events:
        s = e.start_ns() / 1e9
        en = s + e.duration_ns() / 1e9
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if on_device and not e.is_user_annotation():
            kernels.append((e.name(), s, en))
        else:
            host.append((e.name(), s, en))
            if on_device:
                annotations += en - s
    intervals = [(s, e) for _, s, e in kernels]
    busy = union_seconds(intervals)
    by_name: dict[str, float] = defaultdict(float)
    for n, s, e in kernels:
        by_name[n] += e - s
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    if intervals:
        lo = min(s for _, s, _ in host + kernels)
        hi = max(e for _, _, e in host + kernels)
        longest = sorted(idle_gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:10]
        for gs, ge in longest:
            mid = 0.5 * (gs + ge)
            cover = sorted((e - s, n) for n, s, e in host if s <= mid <= e)
            gaps.append(([n for _, n in cover], ge - gs))
    return {"label": label, "wall_s": wall, "busy_s": busy, "kernels": kernels,
            "device_ops": [[n, t] for n, t in device_ops], "idle_gaps": gaps,
            "annotations_s": annotations}


def breakdown(sl: dict, span_names=()) -> dict:
    """The result line's ``breakdown`` from a reduced slice: each idle gap
    named by the innermost host event that spans it, after the innermost
    program span (a name in ``span_names``) among those events."""
    gaps = []
    for cover, seconds in sl["idle_gaps"]:
        name = cover[0] if cover else "host (no traced call)"
        span = next((n for n in cover if n in span_names), None)
        if span is not None and span != name:
            name = f"{span}: {name}"
        gaps.append([name, seconds])
    return {"device_ops": sl["device_ops"], "idle_gaps": gaps}


def units_of(spans, root: str) -> list[list[dict]]:
    """The spans of each root span named ``root``, the root first, in the
    order the roots opened; ``spans`` as ``utils/telemetry.py collect``
    returns them (a parent by its index).  None or no such root: ``[]``."""
    units: dict[int, list[dict]] = {}
    top: list[int] = []
    for i, sp in enumerate(spans or []):
        p = sp["parent"]
        top.append(i if p is None else top[p])
        if top[i] == i and sp["name"] == root:
            units[i] = []
        if top[i] in units:
            units[top[i]].append(sp)
    return list(units.values())


def device_ms(sp: dict) -> float | None:
    """A span's device interval in milliseconds (None if it was not timed on
    the device)."""
    if "device_start_ms" not in sp:
        return None
    return sp["device_end_ms"] - sp["device_start_ms"]


def kernel_seconds(sl: dict, names: tuple[str, ...]) -> tuple[float, int]:
    """Summed device seconds and launch count of the slice's kernels whose
    name contains one of ``names``."""
    hits = [(e - s) for n, s, e in sl["kernels"] if any(k in n for k in names)]
    return sum(hits), len(hits)
