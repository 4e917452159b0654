"""The port's closed demand, drawn in one vectorized pass, against the
JAX package's request-by-request `Workload.generate` and
`make_closed_demand`: equal planes and streams (keys, dtypes, values) at
the benchmark's size (8 cores x 1000 requests, 32 banks, 8 subarrays),
on edge workloads, and through a `generate` a subclass overrides; the
same demands from concurrent threads as from serial calls; numpy's
global generator left alone."""
from __future__ import annotations

import sys
import threading

import numpy as np
import pytest

from repro.core.refresh import scenarios as ref_scenarios
from repro.core.refresh import workload as ref_workload
from repro_torch.core.refresh import scenarios, workload

PRESETS = ("mixed", "read_heavy", "write_heavy", "low_mlp", "streaming")
SEEDS = (0, 1, 2**31 - 1, 2**31 + 3, 2**32 - 1)
N_CORES, REQS, N_BANKS, N_SUB, N_ROWS = 8, 8000, 32, 8, 4096

#: hand-built workloads: (name, Workload fields)
EDGES = {
    "row_hit_0": dict(n_cores=8, mlp=2, think_ns=7.0, row_hit_rate=0.0,
                      write_ratio=0.3, reqs_per_core=1000, seed=11),
    "row_hit_1": dict(n_cores=8, mlp=2, think_ns=7.0, row_hit_rate=1.0,
                      write_ratio=0.3, reqs_per_core=1000, seed=12),
    "one_request": dict(n_cores=8, mlp=1, think_ns=5.0, row_hit_rate=0.9,
                        write_ratio=0.5, reqs_per_core=1, seed=13),
    "one_core": dict(n_cores=1, mlp=4, think_ns=15.0, row_hit_rate=0.5,
                     write_ratio=0.3, reqs_per_core=1000, seed=2**32 - 1),
}

CASES = ([("preset", p, s) for p in PRESETS for s in SEEDS]
         + [("edge", e, None) for e in EDGES] + [("trace", "trace", None)])


def _trace_stream(seed: int = 5, n: int = 700) -> dict:
    rs = np.random.RandomState(seed)
    return dict(is_write=rs.rand(n) < 0.4,
                bank=rs.randint(0, N_BANKS, n), row=rs.randint(0, N_ROWS, n),
                subarray=rs.randint(0, N_SUB, n),
                think_ticks=rs.randint(0, 9, n))


def _workloads(kind: str, name: str, seed):
    """The case's workload in the port and in the reference."""
    if kind == "preset":
        return tuple(m.make_workload(name, n_cores=N_CORES,
                                     reqs_per_core=REQS // N_CORES, seed=seed)
                     for m in (workload, ref_workload))
    if kind == "edge":
        return tuple(m.Workload(name=name, **EDGES[name])
                     for m in (workload, ref_workload))
    return tuple(m.trace_workload("trace", _trace_stream(), dt_ns=6.0)
                 for m in (workload, ref_workload))


def _assert_same_streams(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _assert_same_demand(got, want):
    for k in ("is_write", "bank", "row", "sub", "think"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert (got.name, got.n_banks, got.n_subarrays, got.dt_ns, got.mlp) == (
        want.name, want.n_banks, want.n_subarrays, want.dt_ns, want.mlp)


@pytest.mark.parametrize("kind,name,seed", CASES,
                         ids=[f"{k}-{n}-{s}" for k, n, s in CASES])
def test_demand_equals_reference(kind, name, seed, monkeypatch):
    wl, ref_wl = _workloads(kind, name, seed)
    _assert_same_streams(wl.generate(N_BANKS, N_SUB),
                         ref_wl.generate(N_BANKS, N_SUB))
    # make_closed_demand: a preset's seed goes through the scenario hash;
    # a hand-built or trace workload is the scenario's workload itself
    scen = f"closed_{name}_test"
    for m, w in ((scenarios, wl), (ref_scenarios, ref_wl)):
        make = (lambda reqs, s, m=m: m.make_workload(
            name, n_cores=N_CORES, reqs_per_core=reqs // N_CORES, seed=s)
        ) if kind == "preset" else (lambda reqs, s, w=w: w)
        monkeypatch.setitem(m._CLOSED_SCENARIOS, scen, make)
    args = (scen, N_BANKS, N_SUB, REQS, 0 if seed is None else seed, 6.0)
    _assert_same_demand(scenarios.make_closed_demand(*args),
                        ref_scenarios.make_closed_demand(*args))


def _demands(jobs):
    return [scenarios.make_closed_demand(n, N_BANKS, N_SUB, REQS, s)
            for n, s in jobs]


def test_threads_give_what_serial_calls_give():
    names = ("closed_mixed", "closed_streaming", "closed_multirank",
             "closed_subarray_storm")
    jobs = [[(names[(i + t) % len(names)], 1000 * t + i) for i in range(40)]
            for t in range(2)]
    want = [_demands(j) for j in jobs]
    got = [None, None]

    def work(t):
        got[t] = _demands(jobs[t])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    for g, w in zip(got, want):
        assert g is not None and len(g) == len(w)
        for a, b in zip(g, w):
            _assert_same_demand(a, b)


def test_global_generator_is_left_alone():
    np.random.seed(1234)
    before = np.random.get_state()
    scenarios.make_closed_demand("closed_mixed", N_BANKS, N_SUB, REQS, 7)
    workload.make_workload("low_mlp", seed=3).generate(N_BANKS, N_SUB)
    after = np.random.get_state()
    assert before[0] == after[0] and before[2:] == after[2:]
    np.testing.assert_array_equal(before[1], after[1])
