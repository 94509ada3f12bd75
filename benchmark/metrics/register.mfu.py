"""The traced training phase's operations (the searches over valid pairs,
the pose MLP forward and backward, the points' transforms forward and
backward, counted from shapes) over its wall time at the card's fp32 peak
of 67 TFLOP/s."""

from benchmark.counts import PEAK_FP32_FLOPS


def read(data):
    sl, reg = data.get("slice"), data.get("register")
    if sl is None or reg is None or sl["busy_s"] <= 0:
        return None
    return 100.0 * reg["flops"] / (sl["wall_s"] * PEAK_FP32_FLOPS)
