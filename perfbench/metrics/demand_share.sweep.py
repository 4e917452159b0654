"""Share of the window's sweep time spent in the demand stage, percent:
the benchmark's span around the program's `make_closed_demand` calls
(`core/refresh/scenarios.py`), in cells whose sweeps are handed made
demands."""


def read(data):
    c = data["counters"]
    if not c.get("span_s") or not c.get("demand_made"):
        return None
    return 100.0 * c["demand_s"] / c["span_s"]
