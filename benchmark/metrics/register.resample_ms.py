"""Device milliseconds of a window unit's resamples (the summed device
intervals of its ``register.resample`` spans, one a frame pair); the median
over the traced window's units."""

from statistics import median

from benchmark.trace import device_ms, units_of


def read(data):
    per_unit = []
    for unit in units_of(data.get("spans"), "register"):
        ms = [device_ms(s) for s in unit if s["name"] == "register.resample"]
        if ms and None not in ms:
            per_unit.append(sum(ms))
    return median(per_unit) if per_unit else None
