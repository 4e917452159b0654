"""The reader of the attention backward's spans
(`metrics/attn_backward_share.train.py`) on recorder contents, against
values worked out by hand: the `attn.backward` spans' device seconds in
the window, nothing of the other train spans, and None where the program
has no such span (the parent of the backward kernels) or no recorder."""
import sys

import pytest

from perfbench.test_perfbench_trace_metrics import data, reader, spans

NAME = "attn_backward_share.train"


def test_reads_the_device_seconds_of_attn_backward_spans(monkeypatch):
    rows = [("train.step", 1.0, 9.0), ("train.backward", 1.1, 1.6),
            ("attn.backward", 1.2, 1.3), ("attn.backward", 1.4, 1.5),
            ("attn.backward", 12.0, 13.0)]
    # device times: the two inside the window take 0.75 s and 0.5 s
    events = {1: (1.0, 6.0), 2: (2.0, 2.75), 3: (3.0, 3.5), 4: (20.0, 30.0)}
    spans(monkeypatch, rows, events)
    assert reader(NAME)(data((0.0, 10.0))) == pytest.approx(12.5)


@pytest.mark.parametrize("rows", [
    [("train.step", 0.0, 1.0), ("train.backward", 0.2, 0.4)],
    [("train.step", 5.0, 9.0), ("attn.backward", 5.0, 6.0)]])
def test_none_without_a_span_in_the_window(rows, monkeypatch):
    spans(monkeypatch, rows)
    assert reader(NAME)(data((0.0, 1.0))) is None


def test_none_on_a_program_without_the_recorder(monkeypatch):
    import repro_torch.common
    read = reader(NAME)
    spans(monkeypatch, [("train.step", 0.0, 1.0),
                        ("attn.backward", 0.2, 0.4)])
    assert read(data((0.0, 1.0))) == pytest.approx(20.0)
    monkeypatch.setitem(sys.modules, "repro_torch.common.trace", None)
    monkeypatch.delattr(repro_torch.common, "trace")
    assert read(data((0.0, 1.0))) is None
