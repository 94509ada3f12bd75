"""Seconds a registration spends capturing and instantiating its device
programs (``utils/programs.py`` records), the mean over the window's units."""


def read(data):
    units = data.get("units") or []
    caps = [sum(c["capture_s"] + c["instantiate_s"] for c in u["captures"]) for u in units]
    if not any(u["captures"] for u in units):
        return None
    return sum(caps) / len(caps)
