"""Share of the window's sweep time spent in the finalize stage, percent:
the program's `SweepResult.seconds["finalize"]` (`core/sweep/engine.py`), summed
over the window's sweeps."""


def read(data):
    c = data["counters"]
    if not c.get("span_s") or "finalize_s" not in c:
        return None
    return 100.0 * c["finalize_s"] / c["span_s"]
