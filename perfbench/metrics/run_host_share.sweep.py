"""Share of the window's sweep time in which the device run stage leaves
the card idle, percent: the program's `sweep.run` spans
(`core/sweep/engine._run_mega` around `kernels/sweep_megakernel.run_mega`:
packing, pageable uploads, the launch, the download) less their overlap
with the device's busy intervals, over the sweeps' time."""
import bisect


def overlap(a: float, b: float, busy: list) -> float:
    """Seconds of [a, b] covered by `busy`, disjoint intervals in order."""
    i = max(0, bisect.bisect_right([x for x, _ in busy], a) - 1)
    tot = 0.0
    for x, y in busy[i:]:
        if x >= b:
            break
        tot += max(0.0, min(b, y) - max(a, x))
    return tot


def read(data):
    try:
        from repro_torch.common import trace
    except ImportError:         # a program without the recorder
        return None
    span_s = data["counters"].get("span_s")
    spans = [s for s in trace.records(data["window"])
             if s.name == "sweep.run"]
    if not span_s or not spans:
        return None
    busy = sorted(data["busy"])
    idle = sum(s.end - s.start - overlap(s.start, s.end, busy)
               for s in spans)
    return 100.0 * idle / span_s
