"""The benchmark's harness: one run of one cell.

`run.py` calls `main`. It reads `BENCHMARK.json` and the cell's workload
file (`workloads/<cell>.json`), loads the runner the workload names
(`runners/<kind>.py`) and hands it a `Run`. The runner builds the system,
warms the cell's shapes, measures inside `Run.window()` and checks its
outputs against the reference after the window. Everything the harness
knows of a cell comes from those files, so a later cell, configuration
or per-layer metric is a file added, never an edit.

With ``--trace 1`` the window runs under `torch.profiler` (device
activity only, so the trace stays small) and each per-layer metric of the
cell is read from the trace, the runner's spans and its counters by its
own reader, `metrics/<metric>.py`, whose `read(data)` returns a number or
None where it finds nothing to read.

The last line of standard output is the contract's JSON object; the
compared numbers, each beside its limit, are also the last lines of
standard error.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: modules that may not be loaded in the process that prints the result:
#: JAX, its libraries, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str):
    """Import the file at `path` as a module called `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Top-level names in `sys.modules` that are JAX or the JAX package,
    compared whole (`repro_torch` is not `repro`)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Check:
    """One compared number: passes when ``value <= limit``."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit

    def as_dict(self) -> dict:
        return {"value": self.value, "limit": self.limit}


class Run:
    """What a runner gets: the cell, its configuration, the arguments and
    the clock; and what it fills: spans, counters and the window."""

    def __init__(self, args, t_process: float, bench: dict, cell: dict,
                 workload: dict, config: dict):
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.t_process = t_process
        self.bench, self.cell = bench, cell
        self.workload, self.config = workload, config
        self.spans: list[tuple[str, float, float]] = []
        self.counters: dict = {}
        self.window_t0 = self.window_t1 = None
        self.prof = None
        self.marker_t = None
        #: where the program runs: the card, or the CPU in the tests that
        #: drive a run at a small size with the chip check skipped
        self.device = "cuda"
        #: also read the control's numbers (`control.py`), after the
        #: program's; the benchmark's own runs never do
        self.control = False

    def sync(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        if self.device != "cuda":
            return 0
        import torch
        return int(torch.cuda.max_memory_allocated())

    # ---------------------------------------------------------- timing
    @contextlib.contextmanager
    def span(self, name: str):
        """A span of the benchmark's own, around a call into one layer."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    @contextlib.contextmanager
    def window(self):
        """The measured window: set-up ends where it opens. The device is
        idle at both ends; under ``--trace 1`` the profiler records it."""
        import torch
        self.sync()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            marker = torch.zeros(1, device="cuda")
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            torch.cuda.synchronize()
            # the first kernel of the trace, launched at a known host
            # time: it ties the device clock to `time.perf_counter`
            self.marker_t = time.perf_counter()
            marker.fill_(1.0)
            torch.cuda.synchronize()
        self.window_t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.sync()
            self.window_t1 = time.perf_counter()
            if self.prof is not None:
                self.prof.__exit__(None, None, None)

    @property
    def setup_s(self) -> float:
        return self.window_t0 - self.t_process

    # ------------------------------------------------------------ trace
    def kernels(self) -> list[tuple[str, float, float]]:
        """Device operations of the traced window as (name, start, end) in
        `time.perf_counter` seconds, the marker kernel left out. Read
        from the profiler's raw events, without building its tree of host
        and device events, which takes minutes for a busy window."""
        if self.prof is None:
            return []
        evs = []
        for e in self.prof.profiler.kineto_results.events():
            if not str(e.device_type()).endswith("CUDA"):
                continue
            if hasattr(e, "start_ns"):
                a, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                a, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
            evs.append((e.name()[:160], a, a + d))
        evs.sort(key=lambda e: e[1])
        if not evs:
            return []
        off = self.marker_t - evs[0][1]
        return [(n, a + off, b + off) for n, a, b in evs[1:]]


def busy_intervals(kernels, t0: float, t1: float) -> list[tuple]:
    """The union of kernel intervals, clipped to [t0, t1]."""
    out: list[list[float]] = []
    for _, a, b in sorted(kernels, key=lambda k: k[1]):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def innermost_segments(spans, t0: float, t1: float) -> list[tuple]:
    """[t0, t1] cut where any span starts or ends, each piece named by
    the shortest span that covers it (the host's innermost work)."""
    cuts = sorted({t0, t1, *(x for sp in spans for x in sp[1:]
                             if t0 < x < t1)})
    order = sorted(spans, key=lambda sp: sp[1])
    active: list = []
    out, j = [], 0
    for x, y in zip(cuts, cuts[1:]):
        while j < len(order) and order[j][1] <= x:
            active.append(order[j])
            j += 1
        active = [sp for sp in active if sp[2] >= y]
        name = (min(active, key=lambda sp: sp[2] - sp[1])[0] if active
                else "outside any span")
        out.append((x, y, name))
    return out


def breakdown(kernels, busy, spans, t0: float, t1: float) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the span of the benchmark's own that was open."""
    by_name: dict[str, float] = {}
    for n, a, b in kernels:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, last = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    named: dict[str, float] = {}
    segs = innermost_segments(spans, t0, t1)
    j = 0
    for a, b in gaps:              # both lists come in time order
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            x, y, name = segs[k]
            d = min(b, y) - max(a, x)
            if d > 0:
                named[name] = named.get(name, 0.0) + d
            k += 1
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}


def per_layer_metrics(bench: dict, cell_name: str) -> list:
    """The per-layer metrics that list this cell under ``workloads``."""
    return [m for m in bench["per_layer"] if cell_name in m["workloads"]]


def end_to_end_metrics(bench: dict, cell_name: str) -> list:
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def fail(msg: str, code: int = 2) -> None:
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_cache_dirs() -> None:
    """Every build and kernel cache of the program inside the checkout,
    at fixed paths, so that only a cell's first run there compiles."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    # a library that would load JAX by itself (transformers) may not
    os.environ.setdefault("USE_FLAX", "0")


def main(argv, t_process: float) -> int:
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        fail(f"unknown workload {args.workload!r}; known: {sorted(cells)}")
    cell = cells[args.workload]
    workload = load_json(HERE / "workloads" / f"{cell['name']}.json")
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    set_cache_dirs()
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"the program is not here: {src / 'repro_torch'} is missing")
    sys.path.insert(0, str(src))

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the benchmark measures "
             "the card and does not fall back to the CPU")
    if torch.cuda.device_count() < int(cell["chips"]):
        fail(f"the cell asks for {cell['chips']} cards, "
             f"{torch.cuda.device_count()} are visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))

    run = Run(args, t_process, bench, cell, workload, config)
    runner = load_module(HERE / "runners" / f"{workload['runner']}.py",
                         f"perfbench_runner_{workload['runner']}")
    out = runner.run(run)
    # after the window: the result holds the measured numbers, the
    # peak was read inside the runner before its reference ran
    bad = forbidden_modules()
    if bad:
        fail(f"loaded in this process: {bad}; the benchmark may load "
             f"neither JAX nor the JAX package")

    if args.trace:
        kern = run.kernels()
        t0, t1 = run.window_t0, run.window_t1
        busy = busy_intervals(kern, t0, t1)
        data = {"kernels": kern, "busy": busy, "window": (t0, t1),
                "spans": run.spans, "counters": run.counters,
                "config": config, "workload": workload}
        metrics = {}
        for m in per_layer_metrics(bench, cell["name"]):
            reader = load_module(
                HERE / "metrics" / f"{m['name']}.py",
                "perfbench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(data)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        busy_s = sum(b - a for a, b in busy)
        device_extra = {"busy_s": busy_s, "window_s": t1 - t0}
        extra = {"breakdown": breakdown(kern, busy, run.spans, t0, t1)}
    else:
        metrics = {}
        for m in end_to_end_metrics(bench, cell["name"]):
            if m["name"] == "setup_s":
                v = run.setup_s
            else:
                v = out["end_to_end"][m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_extra, extra = {}, {}

    checks: list[Check] = out["checks"]
    correct = bool(checks) and all(c.ok for c in checks)
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    result = {
        "correct": correct,
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(out["memory_peak_bytes"]),
                   **device_extra},
        **extra,
        "checks": {c.name: c.as_dict() for c in checks},
    }
    print(json.dumps(result), flush=True)
    return 0
