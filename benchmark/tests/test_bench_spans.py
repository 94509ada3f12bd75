"""The readers of the program's spans on a hand-made span list of two
window units, and the profiled slice's reduction on hand-made profiler
events: a range mirrored onto the device is no work, and names an idle gap."""

import pytest
import torch

from conftest import ROOT

from benchmark import harness, trace

MS = 1_000_000   # nanoseconds


def _span(name, parent, start_ms, end_ms, dev=None):
    sp = {"name": name, "parent": parent, "attrs": {}, "start_ns": start_ms * MS,
          "end_ns": end_ms * MS}
    if dev is not None:
        sp["device_start_ms"], sp["device_end_ms"] = dev
    return sp


def _spans():
    """A warm-up outside any unit, then two units as ``collect`` lists them.
    Unit 0: 2 s on the host; device busy 10-90 (segments), 100-1500
    (replays), 1500-1530 and 1600-1640 (resamples): 1,550 ms; IO 0.35 s.
    Unit 1: 3 s; 0-100, 200-2200 and 2200-2250 with a replay inside the
    resample: 2,150 ms; IO 0.6 s."""
    spans = [_span("program.warmup", None, 0, 500)]
    r = len(spans)
    spans += [_span("register", None, 1000, 3000, (0, 0)),
              _span("register.read_frames", r, 1000, 1100),
              _span("register.segment_init", r, 1100, 1190, (10, 90)),
              _span("register.draw_weights", r, 1190, 1240),
              _span("register.phase", r, 1240, 2500)]
    ph = len(spans) - 1
    spans += [_span("program.replay", ph, 1240, 1300, (100, 1000)),
              _span("program.replay", ph, 1300, 1400, (1000, 1500)),
              _span("register.resample", r, 2500, 2530, (1500, 1530)),
              _span("register.resample", r, 2530, 2560, (1600, 1640)),
              _span("register.write_artifacts", r, 2700, 2900)]
    r = len(spans)
    spans += [_span("register", None, 4000, 7000, (0, 0)),
              _span("register.read_frames", r, 4000, 4200),
              _span("register.segment_init", r, 4200, 4300, (0, 100)),
              _span("register.draw_weights", r, 4300, 4400),
              _span("program.replay", r, 4400, 4500, (200, 2200)),
              _span("register.resample", r, 6000, 6100, (2200, 2250))]
    spans += [_span("program.replay", len(spans) - 1, 6010, 6050, (2210, 2240)),
              _span("register.write_artifacts", r, 6500, 6800)]
    return spans


def test_units_are_cut_by_their_root():
    units = trace.units_of(_spans(), "register")
    assert [len(u) for u in units] == [10, 8]
    assert all(u[0]["name"] == "register" for u in units)
    assert trace.units_of(None, "register") == []


@pytest.mark.parametrize("metric,want", [
    ("register.unit_device_idle", (100 * (1 - 1550 / 2000) + 100 * (1 - 2150 / 3000)) / 2),
    ("register.host_io_s", (0.35 + 0.6) / 2),
    ("register.segment_init_ms", (80 + 100) / 2),
    ("register.resample_ms", (70 + 50) / 2),
])
def test_span_reader_on_a_hand_made_span_list(metric, want):
    read = harness.load_metric(ROOT, metric)
    assert read({"spans": _spans()}) == pytest.approx(want, rel=1e-12)
    assert read({"units": []}) is None
    assert read({"spans": []}) is None


@pytest.mark.parametrize("metric", ["register.unit_device_idle", "register.segment_init_ms",
                                    "register.resample_ms"])
def test_device_span_readers_without_device_times(metric):
    """Spans recorded on the CPU carry no device times: nothing to read."""
    spans = [{k: v for k, v in sp.items() if not k.startswith("device_")} for sp in _spans()]
    assert harness.load_metric(ROOT, metric)({"spans": spans}) is None


class _Event:
    def __init__(self, name, start_us, end_us, kind):
        self._name, self._s, self._e, self._kind = name, start_us * 1000, end_us * 1000, kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        on_host = self._kind in ("cpu_op", "cuda_runtime")
        return torch.autograd.DeviceType.CPU if on_host else torch.autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")


def test_slice_keeps_device_work_and_names_gaps_by_span():
    events = [_Event("program.replay", 0, 1000, "cpu_op"),
              _Event("cudaGraphLaunch", 50, 150, "cuda_runtime"),
              _Event("cudaStreamSynchronize", 550, 650, "cuda_runtime"),
              _Event("program.replay", 5, 1000, "gpu_user_annotation"),
              _Event("gemm_kernel", 200, 500, "kernel"),
              _Event("Memcpy DtoD", 700, 750, "gpu_memcpy"),
              _Event("fill_kernel", 750, 900, "kernel"),
              _Event("Memset (Device)", 900, 910, "gpu_memset")]
    sl = trace.reduce_events(events, "slice", 1e-3)
    assert sl["busy_s"] == pytest.approx((300 + 50 + 150 + 10) * 1e-6)
    assert sorted(n for n, _ in sl["device_ops"]) == ["Memcpy DtoD", "Memset (Device)",
                                                       "fill_kernel", "gemm_kernel"]
    assert sl["annotations_s"] == pytest.approx(995e-6)
    gaps = trace.breakdown(sl, {"program.replay"})["idle_gaps"]
    assert gaps[0] == ["program.replay: cudaGraphLaunch", pytest.approx(200e-6)]
    assert gaps[1] == ["program.replay: cudaStreamSynchronize", pytest.approx(200e-6)]
    assert gaps[2][0] == "program.replay"
    # without the span names, a gap is named by the innermost event alone
    assert trace.breakdown(sl)["idle_gaps"][0][0] == "cudaGraphLaunch"
