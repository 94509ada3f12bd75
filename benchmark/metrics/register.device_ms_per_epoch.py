"""Milliseconds the device is busy an epoch in the traced training phase
(the union of its kernels' intervals over the phase's epochs)."""


def read(data):
    sl, reg = data.get("slice"), data.get("register")
    if sl is None or reg is None or sl["busy_s"] <= 0:
        return None
    return 1e3 * sl["busy_s"] / reg["epochs"]
