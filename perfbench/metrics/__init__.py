"""One reader a per-layer metric, named as the metric: `read(data)`
returns its value, or None where the run holds nothing to read.

`data` has ``kernels`` ((name, start, end) of each device kernel of the
traced window, host-clock seconds), ``busy`` (their union), ``window``
(start, end), ``spans`` (the benchmark's own (name, start, end)),
``counters`` (the runner's), ``config`` and ``workload``."""


def kernel_seconds(data: dict, *names: str) -> float:
    """Device seconds of the kernels whose name holds one of `names`."""
    return sum(b - a for n, a, b in data["kernels"]
               if any(x in n for x in names))


def window_seconds(data: dict) -> float:
    t0, t1 = data["window"]
    return t1 - t0


def idle_share(data: dict):
    """Percent of the traced window in which no kernel ran."""
    w = window_seconds(data)
    if w <= 0:
        return None
    return 100.0 * (1.0 - sum(b - a for a, b in data["busy"]) / w)
