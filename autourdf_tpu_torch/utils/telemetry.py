"""Lightweight stage telemetry (port of autourdf_tpu.utils.telemetry).

Every pipeline stage records wall-clock, device, and stage-specific
metrics into ``data/telemetry.json`` — the same records as the JAX
package's stages — plus an opt-in hook into ``torch.profiler`` for deep
dives (the counterpart of ``jax_trace``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field


@dataclass
class Telemetry:
    path: str | None = None
    records: list[dict] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str, **meta):
        t0 = time.time()
        rec = {"stage": name, "start": t0, **meta}
        try:
            yield rec
        finally:
            rec["seconds"] = round(time.time() - t0, 3)
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


@contextlib.contextmanager
def torch_trace(log_dir: str | None):
    """Opt-in ``torch.profiler`` trace of the block, host and (where a card
    is present) device activity, written to ``log_dir`` as a Chrome trace
    (view with TensorBoard's profiler plugin or chrome://tracing)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
