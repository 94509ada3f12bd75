"""Stage telemetry and spans (port of autourdf_tpu.utils.telemetry).

Every pipeline stage records wall-clock, device, and stage-specific
metrics into ``data/telemetry.json`` — the same records as the JAX
package's stages.

Spans time the layers inside a stage.  They are off by default: ``span``
then checks one flag and returns a shared no-op context.  :func:`enable`
turns them on; each span then records its name, its parent, its attributes
and its start and end on ``time.perf_counter_ns()``, kept in memory until
:func:`collect` returns and clears them.  A span opened with
``device=True`` on a CUDA device also records a timing event on the current
stream at its start and at its end (never inside a capture, and never
waiting for the device); :func:`collect` resolves them into device times
from the root span's first event.  While a ``torch.profiler`` runs, every
span also opens a range of its name, so it appears as a host event in the
profiler's trace, on the kernels' clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import torch

_on = False
_spans: list["_Span"] = []
_open: list["_Span"] = []
_seq = 0          # spans opened in this process: a stage sums those it opened


class _NoSpan:
    """What :func:`span` returns while spans are off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("seq", "name", "parent", "attrs", "start_ns", "end_ns", "events", "_range")

    def __init__(self, name: str, device: bool, attrs: dict):
        global _seq
        self.seq = _seq
        _seq += 1
        self.name = name
        self.attrs = attrs
        self.parent = _open[-1] if _open else None
        self.start_ns = self.end_ns = None
        self.events = self._range = None
        if device and torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        _spans.append(self)
        _open.append(self)
        if torch.autograd._profiler_enabled():
            # an operator's range, not record_function's user annotation: the
            # profiler mirrors an annotation onto the device as an interval
            # of its own, which a reader of the device's busy time counts
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        if self.events is not None:
            self.events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _open.pop()
        return False

    def note(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def device_seconds(self) -> float | None:
        if self.events is None or self.end_ns is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1]) / 1e3


def span(name: str, device: bool = False, **attrs):
    """A context that records a span while spans are on (see the module's
    docstring); ``device=True`` also times it on the device."""
    if not _on:
        return _NO_SPAN
    return _Span(name, device, attrs)


def enable(on: bool = True) -> None:
    """Turn spans on (or off) for the process."""
    global _on
    _on = on


def _root(sp: _Span) -> _Span:
    while sp.parent is not None:
        sp = sp.parent
    return sp


def collect() -> list[dict]:
    """The spans recorded since the last call, in the order they opened, and
    clear them.  Each is a dict: ``name``, ``parent`` (an index into the
    list, or None), ``attrs``, ``start_ns`` and ``end_ns`` (host,
    ``perf_counter_ns``; ``end_ns`` None while it is open) and, for a span
    timed on the device whose root was too, ``device_start_ms`` and
    ``device_end_ms`` from the root's first event."""
    taken = list(_spans)
    _spans.clear()
    index = {id(sp): i for i, sp in enumerate(taken)}
    out = []
    for sp in taken:
        rec = {"name": sp.name, "parent": index.get(id(sp.parent)), "attrs": dict(sp.attrs),
               "start_ns": sp.start_ns, "end_ns": sp.end_ns}
        zero = _root(sp).events
        if sp.events is not None and zero is not None and sp.end_ns is not None:
            sp.events[1].synchronize()
            rec["device_start_ms"] = zero[0].elapsed_time(sp.events[0])
            rec["device_end_ms"] = zero[0].elapsed_time(sp.events[1])
        out.append(rec)
    return out


def _summary(since: int) -> dict:
    """Count, host seconds and device seconds by name of the closed spans
    opened since sequence number ``since``."""
    out: dict[str, dict] = {}
    for sp in _spans:
        if sp.seq < since or sp.end_ns is None:
            continue
        s = out.setdefault(sp.name, {"count": 0, "host_s": 0.0, "device_s": None})
        s["count"] += 1
        s["host_s"] += (sp.end_ns - sp.start_ns) / 1e9
        dev = sp.device_seconds()
        if dev is not None:
            s["device_s"] = (s["device_s"] or 0.0) + dev
    return out


@dataclass
class Telemetry:
    path: str | None = None
    records: list[dict] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str, **meta):
        """Wrap a stage's work: its record gets ``seconds``, its wall time
        and, while spans are on, ``spans`` (the summary of those it opened)
        and ``programs`` (the program counters' change over it)."""
        from . import programs

        t0 = time.time()
        rec = {"stage": name, "start": t0, **meta}
        traced = _on
        since, counts = _seq, dict(programs.counters)
        try:
            yield rec
        finally:
            rec["seconds"] = round(time.time() - t0, 3)
            if traced:
                rec["spans"] = _summary(since)
                rec["programs"] = {k: v - counts[k] for k, v in programs.counters.items()}
            self.records.append(rec)
            if self.path:
                self.flush()

    def flush(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        existing = []
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    existing = json.load(f)
            except (json.JSONDecodeError, OSError):
                existing = []
        with open(self.path, "w") as f:
            json.dump(existing + self.records, f, indent=1)
        self.records = []
