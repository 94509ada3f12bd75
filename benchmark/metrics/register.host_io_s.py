"""Host seconds a window unit spends reading its frames, drawing its MLP
weights and writing its artifacts (its ``register.read_frames``,
``register.draw_weights`` and ``register.write_artifacts`` spans); the
median over the traced window's units."""

from statistics import median

from benchmark.trace import units_of

IO = ("register.read_frames", "register.draw_weights", "register.write_artifacts")


def read(data):
    per_unit = []
    for unit in units_of(data.get("spans"), "register"):
        io = [s for s in unit if s["name"] in IO]
        if io:
            per_unit.append(sum(s["end_ns"] - s["start_ns"] for s in io) / 1e9)
    return median(per_unit) if per_unit else None
