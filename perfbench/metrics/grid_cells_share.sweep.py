"""Share of the window's sweep time spent in `_Grid`'s per-cell loop,
percent: the program's `sweep.grid.cells` spans (`core/sweep/engine._Grid`:
`resolve_policy`, `classify`, the timing and phase planes of each cell)
over the sweeps' time."""


def read(data):
    try:
        from repro_torch.common import trace
    except ImportError:         # a program without the recorder
        return None
    span_s = data["counters"].get("span_s")
    spans = [s for s in trace.records(data["window"])
             if s.name == "sweep.grid.cells"]
    if not span_s or not spans:
        return None
    return 100.0 * sum(s.end - s.start for s in spans) / span_s
