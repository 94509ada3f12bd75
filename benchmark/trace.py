"""A profiled slice of a run and what the per-layer readers take from it.

``DeviceSlice`` runs ``torch.profiler`` around a bounded part of one unit and
reduces the trace to: every device kernel's name and interval, the device's
busy seconds (the union of the kernel intervals), the slice's wall seconds on
the host clock, and the breakdown the result line carries (the device
operations that took most time, and the ten longest idle gaps, each named by the
innermost host call that spans it).
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
        self.result = self.reduce(self._prof, wall)
        self._prof = None
        return self.result

    def reduce(self, prof, wall: float) -> dict:
        kernels, host = [], []
        # the profiler's raw events: building its FunctionEvents for a
        # whole URDF build's some 10^6 events takes minutes
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns() / 1e9
            en = s + e.duration_ns() / 1e9
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                kernels.append((e.name(), s, en))
            else:
                host.append((e.name(), s, en))
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
                inner = [(e - s, n) for n, s, e in host if s <= mid <= e]
                gaps.append((min(inner)[1] if inner else "host (no traced call)", ge - gs))
        return {"label": self.label, "wall_s": wall, "busy_s": busy, "kernels": kernels,
                "device_ops": [[n, t] for n, t in device_ops],
                "idle_gaps": [[n, t] for n, t in gaps]}


def breakdown(sl: dict) -> dict:
    """The result line's ``breakdown`` from a reduced slice."""
    return {"device_ops": sl["device_ops"], "idle_gaps": sl["idle_gaps"]}


def kernel_seconds(sl: dict, names: tuple[str, ...]) -> tuple[float, int]:
    """Summed device seconds and launch count of the slice's kernels whose
    name contains one of ``names``."""
    hits = [(e - s) for n, s, e in sl["kernels"] if any(k in n for k in names)]
    return sum(hits), len(hits)
