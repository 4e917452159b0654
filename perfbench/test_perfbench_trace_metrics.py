"""The readers of the program's spans (`metrics/*` with source
`program_span`) on synthetic data and recorder contents, against values
worked out by hand: spans outside the window are left out, a span that
crosses its edge counts inside it, a `sweep.run` span half covered by
device work counts its other half, device seconds come from the spans'
events, and a reader finds nothing where its spans are absent."""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.common import trace
from repro_torch.common.trace import Span

HERE = Path(__file__).resolve().parent
READERS = ["demand_prog_share.sweep", "grid_cells_share.sweep",
           "run_host_share.sweep", "forward_share.train",
           "backward_share.train", "optimizer_share.train"]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Event:
    """A stand-in for a CUDA event at a device time in seconds."""

    def __init__(self, t: float):
        self.t = t

    def elapsed_time(self, end: "Event") -> float:
        return (end.t - self.t) * 1e3


def spans(monkeypatch, rows, events=None):
    """Put `rows` (name, start, end) in the recorder as one tree under
    the first row, and `events` {row index: (device start, end)}."""
    recs = [Span(n, a, b, None if i == 0 else 0, 0, i)
            for i, (n, a, b) in enumerate(rows)]
    monkeypatch.setattr(trace, "_records", recs)
    monkeypatch.setattr(trace, "_events", {
        i: (Event(a), Event(b)) for i, (a, b) in (events or {}).items()})


def data(window, span_s=None, busy=()):
    return {"kernels": [], "busy": list(busy), "window": window,
            "spans": [("demand", *window)], "config": {}, "workload": {},
            "counters": {} if span_s is None else {"span_s": span_s}}


def test_demand_prog_share_sums_demand_spans_in_the_window(monkeypatch):
    spans(monkeypatch, [("sweep", 9.0, 20.0), ("demand", 11.0, 12.0),
                        ("demand", 12.5, 13.0), ("demand", 9.0, 10.5),
                        ("demand", 25.0, 26.0), ("sweep.grid", 11.0, 14.0)])
    # 1 + 0.5 + 0.5 (clipped at 10) of 8 s of sweeps
    assert reader("demand_prog_share.sweep")(
        data((10.0, 20.0), span_s=8.0)) == pytest.approx(25.0)


def test_grid_cells_share_sums_cell_loop_spans(monkeypatch):
    spans(monkeypatch, [("sweep", 0.0, 10.0),
                        ("sweep.grid.cells", 1.0, 1.25),
                        ("sweep.grid.cells", 4.0, 4.5),
                        ("sweep.grid.cells", 30.0, 31.0),
                        ("demand", 2.0, 3.0)])
    assert reader("grid_cells_share.sweep")(
        data((0.0, 10.0), span_s=5.0)) == pytest.approx(15.0)


def test_run_host_share_counts_the_idle_part_of_run_spans(monkeypatch):
    spans(monkeypatch, [("sweep", 0.0, 10.0), ("sweep.run", 1.0, 3.0),
                        ("sweep.run", 5.0, 6.0), ("sweep.run", 12.0, 13.0),
                        ("sweep.grid", 0.0, 1.0)])
    busy = [(0.2, 0.5), (2.0, 4.0), (5.2, 5.4), (5.6, 5.7), (12.0, 13.0)]
    # (1, 3) half under (2, 4): 1 s idle; (5, 6) less 0.2 and 0.1: 0.7
    assert reader("run_host_share.sweep")(
        data((0.0, 10.0), span_s=5.0, busy=busy)) == pytest.approx(34.0)


@pytest.mark.parametrize("name,value", [("forward", 17.0),
                                        ("backward", 60.0),
                                        ("optimizer", 2.5)])
def test_train_shares_read_device_seconds(name, value, monkeypatch):
    rows = [("train.step", 1.0, 9.0),
            ("train.forward", 1.0, 1.1), ("train.backward", 1.1, 1.2),
            ("train.forward", 1.2, 1.3), ("train.backward", 1.3, 1.4),
            ("train.optimizer", 1.4, 1.5), ("train.forward", 11.0, 12.0)]
    # the host ran ahead: each span's device time is its events'
    events = {1: (1.0, 1.8), 2: (1.8, 4.8), 3: (4.8, 5.7), 4: (5.7, 8.7),
              5: (8.7, 8.95), 6: (20.0, 30.0)}
    spans(monkeypatch, rows, events)
    assert reader(f"{name}_share.train")(
        data((0.0, 10.0))) == pytest.approx(value)


def test_train_share_without_events_reads_host_seconds(monkeypatch):
    spans(monkeypatch, [("train.step", 1.0, 5.0),
                        ("train.forward", 1.0, 3.0)])
    assert reader("forward_share.train")(
        data((0.0, 8.0))) == pytest.approx(25.0)


@pytest.mark.parametrize("name", READERS)
def test_none_where_the_spans_are_absent(name, monkeypatch):
    read = reader(name)
    spans(monkeypatch, [("sweep", 0.0, 1.0), ("other", 0.2, 0.4)])
    assert read(data((0.0, 1.0), span_s=1.0)) is None
    # the reader's own spans, all outside the window
    own = {"demand_prog_share.sweep": "demand",
           "grid_cells_share.sweep": "sweep.grid.cells",
           "run_host_share.sweep": "sweep.run"}.get(
        name, "train." + name.split("_")[0])
    spans(monkeypatch, [("sweep", 5.0, 9.0), (own, 5.0, 6.0)])
    assert read(data((0.0, 1.0), span_s=1.0)) is None
    assert read(data((4.0, 10.0), span_s=6.0)) > 0
    monkeypatch.setattr(trace, "_records", [])
    assert read(data((0.0, 1.0), span_s=1.0)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_on_a_program_without_the_recorder(name, monkeypatch):
    """The parent of the recorder's commit runs these readers too."""
    import sys

    import repro_torch.common
    read = reader(name)
    spans(monkeypatch, [("sweep", 0.0, 1.0)] + [
        (n, 0.2, 0.4) for n in ("demand", "sweep.grid.cells", "sweep.run",
                                "train.forward", "train.backward",
                                "train.optimizer")])
    assert read(data((0.0, 1.0), span_s=1.0)) > 0
    monkeypatch.setitem(sys.modules, "repro_torch.common.trace", None)
    monkeypatch.delattr(repro_torch.common, "trace")
    assert read(data((0.0, 1.0), span_s=1.0)) is None
