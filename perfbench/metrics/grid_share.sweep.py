"""Share of the window's sweep time spent in the grid stage, percent:
the program's `SweepResult.seconds["grid"]` (`core/sweep/engine.py`), summed
over the window's sweeps."""


def read(data):
    c = data["counters"]
    if not c.get("span_s") or "grid_s" not in c:
        return None
    return 100.0 * c["grid_s"] / c["span_s"]
