"""Share of the window's sweep time spent making demands, percent: the
program's own `demand` spans (`core/refresh/scenarios.make_closed_demand`,
wherever it is called: by the runner in the ladder, by `_Grid` in the
paper grid) over the sweeps' time."""


def read(data):
    try:
        from repro_torch.common import trace
    except ImportError:         # a program without the recorder
        return None
    span_s = data["counters"].get("span_s")
    spans = [s for s in trace.records(data["window"]) if s.name == "demand"]
    if not span_s or not spans:
        return None
    return 100.0 * sum(s.end - s.start for s in spans) / span_s
