"""Share of the traced training phase's wall time in which no kernel ran on
the device."""


def read(data):
    sl = data.get("slice")
    if sl is None or sl["busy_s"] <= 0 or data.get("register") is None:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["wall_s"])
