"""Device milliseconds of a window unit's frame-0 segmentation (the device
interval of its ``register.segment_init`` span); the median over the traced
window's units."""

from statistics import median

from benchmark.trace import device_ms, units_of


def read(data):
    per_unit = [device_ms(s) for unit in units_of(data.get("spans"), "register")
                for s in unit if s["name"] == "register.segment_init"]
    per_unit = [ms for ms in per_unit if ms is not None]
    return median(per_unit) if per_unit else None
