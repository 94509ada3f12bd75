"""Share of a window unit's host time in which none of its device-timed
spans ran on the device: one minus the union of the device intervals of its
``program.replay``, ``register.resample`` and ``register.segment_init``
spans over the host seconds of its root ``register`` span; the median over
the traced window's units."""

from statistics import median

from benchmark.trace import union_seconds, units_of

TIMED = ("program.replay", "register.resample", "register.segment_init")


def read(data):
    shares = []
    for unit in units_of(data.get("spans"), "register"):
        root = unit[0]
        busy = [(s["device_start_ms"], s["device_end_ms"]) for s in unit
                if s["name"] in TIMED and "device_start_ms" in s]
        if busy and root["end_ns"] is not None:
            host_ms = (root["end_ns"] - root["start_ns"]) / 1e6
            shares.append(100.0 * (1.0 - union_seconds(busy) / host_ms))
    return median(shares) if shares else None
