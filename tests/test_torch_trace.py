"""The port's span recorder (`repro_torch.common.trace`) and the spans the
sweep and the training step record: off by default and free there, on
under `trace.enable()` or a `torch.profiler` profile, parents and roots
by nesting, the sweep's and the step's span trees on the CPU, and
`SweepResult.seconds` read from the same clock reads as its spans."""
import threading
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.common import get_arch, trace
from repro_torch.common.treeutil import tree_leaves
from repro_torch.core.sweep import SweepSpec, sweep
from repro_torch.data import SyntheticLMData
from repro_torch.models.dims import make_dims
from repro_torch.optim import OptConfig
from repro_torch.train.step import make_state, make_train_step

from _torch_train_parity import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

SCENARIOS = ("closed_mixed", "closed_streaming", "closed_low_mlp")


@pytest.fixture(autouse=True)
def fresh_recorder(monkeypatch):
    """No spans leak between tests on one worker."""
    monkeypatch.setattr(trace, "_enabled", 0)
    trace.clear()
    yield
    trace.clear()


@pytest.fixture()
def no_events(monkeypatch):
    """Fail any test that makes a CUDA event."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA event was made")
    monkeypatch.setattr(torch.cuda, "Event", refuse)


def tiny_spec(**kw) -> SweepSpec:
    return SweepSpec(policies=("ref_ab", "darp"), scenarios=SCENARIOS,
                     densities=(8,), reqs=120, seed=5, mode="closed", **kw)


def names(spans) -> list:
    return [s.name for s in spans]


# ---------------------------------------------------------- recorder
def test_off_by_default_records_nothing(no_events):
    assert not trace.recording()
    a, b = trace.span("x"), trace.span("y", "cuda")
    assert a is b                      # one shared no-op context
    with a as got:
        assert got is None
    res = sweep(tiny_spec(), backend="mega", device="cpu")
    assert trace.records() == []
    assert set(res.seconds) == {"grid", "run", "finalize"}
    assert all(v > 0 for v in res.seconds.values())


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_enable_and_a_profile_turn_recording_on(how, no_events):
    on = (trace.enable() if how == "enable"
          else profile(activities=[ProfilerActivity.CPU]))
    with on:
        assert trace.recording()
        with trace.span("inside", "cpu"):
            pass
    assert not trace.recording()
    with trace.span("after"):
        pass
    [s] = trace.records()
    assert s.name == "inside" and s.end >= s.start
    assert trace.device_seconds(s) == s.end - s.start


def test_nesting_gives_parent_and_root():
    with trace.enable():
        with trace.span("a"):
            with trace.span("b"):
                with trace.span("c"):
                    pass
            with trace.span("d"):
                pass
        with trace.span("e"):
            pass
    by = {s.name: s for s in trace.records()}
    assert names(trace.records()) == ["c", "b", "d", "a", "e"]
    a, b, c, d, e = (by[k] for k in "abcde")
    assert a.parent is None and a.root == a.id
    assert b.parent == a.id and d.parent == a.id and c.parent == b.id
    assert {b.root, c.root, d.root} == {a.id}
    assert e.parent is None and e.root == e.id != a.id
    assert a.start <= b.start <= c.start <= c.end <= b.end <= d.start
    assert d.end <= a.end <= e.start


def test_parents_are_found_per_thread():
    seen = []

    def other():
        with trace.span("t"):
            pass
        seen.append(True)

    with trace.enable():
        with trace.span("main"):
            th = threading.Thread(target=other)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    assert seen
    by = {s.name: s for s in trace.records()}
    assert by["t"].parent is None and by["t"].root == by["t"].id


def test_threads_record_every_span_under_their_own_roots():
    """More threads than cores, switching often: no span is lost and
    every child's parent and root lie in its own thread's tree."""
    import os
    import sys
    n_threads, n_spans = 2 * (os.cpu_count() or 1) + 2, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(n_spans):
                with trace.span(f"outer{k}"):
                    with trace.span(f"inner{k}"):
                        pass
        with trace.enable():
            ths = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=60)
        assert not any(th.is_alive() for th in ths)
    finally:
        sys.setswitchinterval(interval)
    recs = trace.records()
    assert len(recs) == 2 * n_threads * n_spans
    by_id = {s.id: s for s in recs}
    for s in recs:
        if s.name.startswith("inner"):
            up = by_id[s.parent]
            assert up.name == "outer" + s.name[5:] and s.root == up.id
        else:
            assert s.parent is None and s.root == s.id


def test_records_clip_to_a_window():
    with trace.enable():
        with trace.span("s"):
            pass
    [s] = trace.records()
    mid = (s.start + s.end) / 2
    [c] = trace.records((mid, s.end + 1.0))
    assert (c.start, c.end, c.id) == (mid, s.end, s.id)
    assert trace.records((s.end + 1.0, s.end + 2.0)) == []


# ------------------------------------------------------------- sweep
def test_sweep_span_tree():
    with trace.enable():
        res = sweep(tiny_spec(), backend="mega", device="cpu")
    recs = trace.records()
    by = {}
    for s in recs:
        by.setdefault(s.name, []).append(s)
    [top] = by["sweep"]
    [grid] = by["sweep.grid"]
    [cells] = by["sweep.grid.cells"]
    [run] = by["sweep.run"]
    [fin] = by["sweep.finalize"]
    assert top.parent is None and {s.root for s in recs} == {top.id}
    assert grid.parent == run.parent == fin.parent == top.id
    assert cells.parent == grid.id
    assert len(by["demand"]) == len(SCENARIOS)
    assert all(s.parent == grid.id for s in by["demand"])
    assert max(s.end for s in by["demand"]) <= cells.start
    assert grid.end <= run.start and run.end <= fin.start
    assert sorted(by) == ["demand", "sweep", "sweep.finalize", "sweep.grid",
                          "sweep.grid.cells", "sweep.run"]
    assert res.seconds == {"grid": grid.end - grid.start,
                           "run": run.end - run.start,
                           "finalize": fin.end - fin.start}


@pytest.mark.parametrize("on", [False, True])
def test_sweep_seconds_are_the_spans_clock_reads(on, monkeypatch):
    """A clock that advances one second a read: with spans off only the
    three stages read it, twice each; on, each stage's seconds are its
    span's."""
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))
    if on:
        with trace.enable():
            res = sweep(tiny_spec(), backend="mega", device="cpu")
        by = {s.name: s.end - s.start for s in trace.records()}
        assert res.seconds == {"grid": by["sweep.grid"],
                               "run": by["sweep.run"],
                               "finalize": by["sweep.finalize"]}
        # the grid's span holds its own two reads and its children's
        assert res.seconds["grid"] == 1.0 + 2 * (len(SCENARIOS) + 1)
    else:
        res = sweep(tiny_spec(), backend="mega", device="cpu")
        assert res.seconds == {"grid": 1.0, "run": 1.0, "finalize": 1.0}
        assert next(ticks) == 6


@pytest.mark.parametrize("backend", ["batched", "torch"])
def test_other_backends_record_the_sweep_and_its_grid(backend):
    with trace.enable():
        res = sweep(tiny_spec(), backend=backend, device="cpu")
    assert res.seconds is None
    got = names(trace.records())
    assert got.count("sweep") == got.count("sweep.grid") == 1
    assert got.count("demand") == len(SCENARIOS)
    assert got[-1] == "sweep"


# --------------------------------------------------------- train step
def test_train_step_span_tree():
    cfg = get_arch("qwen2-0.5b").reduced()
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    ocfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    state = make_state(torch.Generator().manual_seed(0), cfg, dims, ocfg,
                       device="cpu")
    step = make_train_step(cfg, dims, ocfg, accum=2, device="cpu")
    batch = SyntheticLMData(cfg.vocab_size, batch=2, seq=16,
                            seed=0).batch_at(0)
    plain, _ = step(state, batch)
    with trace.enable():
        traced, met = step(state, batch)
    assert torch.isfinite(met["loss"])
    for a, b in zip(tree_leaves(plain), tree_leaves(traced)):
        assert torch.equal(a, b)
    recs = trace.records()
    [top] = [s for s in recs if s.name == "train.step"]
    assert top.parent is None and {s.root for s in recs} == {top.id}
    assert names(recs) == ["train.forward", "train.backward"] * 2 + [
        "train.optimizer", "train.step"]
    assert all(s.parent == top.id for s in recs if s is not top)
    inner = [s for s in recs if s is not top]
    assert all(x.end <= y.start for x, y in zip(inner, inner[1:]))
