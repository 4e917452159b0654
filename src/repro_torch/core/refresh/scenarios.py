"""Registry-style scenario (workload) library for the sweep engine.

`workload.Workload` models the *closed-loop* front-end the timing-accurate
`DramSim` needs (MLP-limited cores that stall on outstanding requests).
The batched sweep engine (`repro_torch.core.sweep`) instead consumes *open-loop
traces*: flat arrays of (arrive_tick, bank, row, subarray, is_write),
sorted by arrival — the shape that stacks across a (workload, policy,
density) grid. This module is the library of such traces.

Scenarios are registered by name, mirroring the policy registry:

    @register_scenario("read_heavy")
    def read_heavy(n_banks, n_subarrays, reqs, rs): ...

    trace = make_trace("read_heavy", seed=1)       # deterministic per seed
    list_scenarios()                               # sorted names

Every generator receives a `numpy.random.RandomState` derived from
(name, seed) so two scenarios in one grid never share a stream, and the
same (name, seed) always reproduces the same trace bit-for-bit.

The built-in library spans the pressure axes the paper's evaluation (and
the arXiv:1805.01289 follow-up) show matter for refresh policies:

  read_heavy               almost-pure reads, moderate locality
  write_burst_draining     quiet read phases + write bursts that trip the
                           write-drain watermark (exercises DARP's WRP)
  row_buffer_friendly      long same-row runs (high hit rate; refresh
                           closes rows, so REF cost is mostly re-activates)
  bank_camping             traffic concentrated on two hot banks (DARP's
                           idle-bank harvesting has easy pickings; the hot
                           banks postpone to the budget edge)
  subarray_conflict_adversarial
                           accesses chase the subarray the round-robin
                           refresh counter targets next (worst case for
                           SARP, near-best for plain per-bank refresh)
  trace_replay             replay an explicit (arrive, bank, row, sub,
                           is_write) trace, e.g. captured from a real run
  mixed                    the legacy `make_workload("mixed")` analogue
  streaming                high-rate, high-locality bandwidth stress

Times are integer *ticks* (the sweep engine's quantum, default 6 ns); a
trace is density-independent — the grid reuses one trace per (scenario,
seed) across every policy and density so cells stay comparable.

Closed-loop scenarios live in a second registry: a closed scenario
names a `workload.Workload` — the SAME MLP-limited multi-core generator
`DramSim` consumes — so the sweep engine's closed-loop mode and the
event/tick simulators replay one demand stream:

    @register_closed_scenario("closed_mixed")
    def closed_mixed(reqs, seed): return make_workload("mixed", ...)

    dem = make_closed_demand("closed_mixed", seed=1)   # quantized ticks
    list_closed_scenarios()

`make_closed_demand` stacks the per-core streams into [n_cores, n_req]
arrays with think gaps quantized via `workload.quantize_streams`, and
keeps the originating `Workload` on the result so conformance tests can
hand the identical demand to `DramSim`.

Serving scenarios live in a third registry: a `serving_*` entry
is a *request arrival process* for the continuous-batching serving loop
(`repro.serving.EngineCore` driven by `repro.serving.cosim`) — per
request an arrival round, a prompt length, a decode budget, and a
priority class:

    @register_serving_scenario("serving_bursty")
    def serving_bursty(n, rs): return ServingArrivals(...)

    arr = make_serving_arrivals("serving_bursty", n_requests=200, seed=0)
    list_serving_scenarios()

The built-ins span the arrival shapes that matter for refresh-vs-SLO
scheduling: `serving_diurnal` (slow sinusoidal load swing),
`serving_bursty` (dense request bursts with quiet valleys — DARP's
harvesting ground), `serving_heavy_tail` (Pareto-ish prompt mix with
priority classes). Deterministic per (name, seed) like the other two
registries; the reference package's registry-coverage analysis pass (RC407) fails CI
when a registered `serving_*` scenario never reaches the co-sim test
matrix (`tests/test_serving_cosim.py`).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np

from repro_torch.common import trace
from repro_torch.core.refresh.workload import (Workload, make_workload,
                                         quantize_streams)

N_ROWS = 4096               # rows per bank exposed to scenarios

_SCENARIOS: Dict[str, Callable] = {}


@dataclass(frozen=True)
class Trace:
    """Open-loop request trace: parallel arrays sorted by `arrive`."""
    name: str
    arrive: np.ndarray          # int32 ticks, non-decreasing
    bank: np.ndarray            # int32 in [0, n_banks)
    row: np.ndarray             # int32 in [0, N_ROWS)
    sub: np.ndarray             # int32 in [0, n_subarrays)
    is_write: np.ndarray        # bool
    n_banks: int
    n_subarrays: int

    def __len__(self) -> int:
        return int(self.arrive.shape[0])

    def validate(self) -> "Trace":
        n = len(self)
        assert all(len(a) == n for a in
                   (self.bank, self.row, self.sub, self.is_write))
        assert n > 0
        assert (np.diff(self.arrive) >= 0).all(), "arrivals must be sorted"
        assert self.arrive[0] >= 0
        assert (0 <= self.bank).all() and (self.bank < self.n_banks).all()
        assert (0 <= self.row).all() and (self.row < N_ROWS).all()
        assert (0 <= self.sub).all() and (self.sub < self.n_subarrays).all()
        return self


def register_scenario(name: str, fn: Callable = None, *,
                      override: bool = False):
    """Register a trace generator under `name` (decorator or direct call).

    The generator is called as `fn(n_banks, n_subarrays, reqs, rs, **cfg)`
    and must return a `Trace`. Collisions raise unless `override=True`,
    matching `register_policy`.
    """
    def deco(obj):
        if not override and name in _SCENARIOS:
            raise ValueError(
                f"scenario {name!r} is already registered; pass "
                f"override=True to replace it")
        _SCENARIOS[name] = obj
        return obj
    if fn is not None:
        return deco(fn)
    return deco


def list_scenarios() -> list[str]:
    return sorted(_SCENARIOS)


def _rs(name: str, seed: int) -> np.random.RandomState:
    """Per-(scenario, seed) stream: stable across processes and runs."""
    h = hashlib.sha256(f"{name}:{seed}".encode()).digest()
    return np.random.RandomState(int.from_bytes(h[:4], "little"))


def make_trace(name: str, n_banks: int = 8, n_subarrays: int = 8,
               reqs: int = 800, seed: int = 0, **cfg) -> Trace:
    """Generate the named scenario's trace (KeyError lists known names)."""
    try:
        fn = _SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: "
            f"{', '.join(sorted(_SCENARIOS))}") from None
    return fn(n_banks, n_subarrays, reqs, _rs(name, seed), **cfg).validate()


# --------------------------------------------------------------- helpers
def _assemble(name, n_banks, n_subarrays, arrive, bank, row, is_write,
              sub=None) -> Trace:
    order = np.argsort(arrive, kind="stable")
    arrive = np.asarray(arrive, np.int32)[order]
    bank = np.asarray(bank, np.int32)[order]
    row = np.asarray(row, np.int32)[order]
    is_write = np.asarray(is_write, bool)[order]
    sub = (row % n_subarrays if sub is None
           else np.asarray(sub, np.int32)[order])
    return Trace(name, arrive, bank, row, np.asarray(sub, np.int32),
                 is_write, n_banks, n_subarrays)


def _locality(rs, bank, row, p_reuse: float):
    """With probability p_reuse, repeat the previous (bank, row)."""
    reuse = rs.rand(len(bank)) < p_reuse
    for i in range(1, len(bank)):
        if reuse[i]:
            bank[i] = bank[i - 1]
            row[i] = row[i - 1]
    return bank, row


def _poisson_arrivals(rs, n: int, mean_gap: float) -> np.ndarray:
    return np.floor(np.cumsum(rs.exponential(mean_gap, n))).astype(np.int64)


# ------------------------------------------------------------- scenarios
@register_scenario("read_heavy")
def read_heavy(n_banks, n_subarrays, reqs, rs):
    arrive = _poisson_arrivals(rs, reqs, 3.0)
    bank = rs.randint(0, n_banks, reqs)
    row = rs.randint(0, N_ROWS, reqs)
    bank, row = _locality(rs, bank, row, 0.55)
    is_write = rs.rand(reqs) < 0.05
    return _assemble("read_heavy", n_banks, n_subarrays,
                     arrive, bank, row, is_write)


@register_scenario("write_burst_draining")
def write_burst_draining(n_banks, n_subarrays, reqs, rs,
                         burst: int = 48, phase_reads: int = 32):
    """Quiet read phases punctuated by dense write bursts sized to trip the
    engine's high watermark — the shape DARP's WRP component feeds on."""
    arrive, bank, row, is_write = [], [], [], []
    t, left = 0, reqs
    while left > 0:
        nr = min(phase_reads, left)
        gaps = rs.exponential(4.0, nr)
        for g in gaps:
            t += max(1, int(g))
            arrive.append(t)
        bank.extend(rs.randint(0, n_banks, nr))
        row.extend(rs.randint(0, N_ROWS, nr))
        is_write.extend([False] * nr)
        left -= nr
        nw = min(burst, left)
        for i in range(nw):
            arrive.append(t + 1 + i // 2)      # ~2 writes per tick
        bank.extend(rs.randint(0, n_banks, nw))
        row.extend(rs.randint(0, N_ROWS, nw))
        is_write.extend([True] * nw)
        t += 1 + nw // 2 + 40                  # drain room before next phase
        left -= nw
    return _assemble("write_burst_draining", n_banks, n_subarrays,
                     arrive, bank, row, is_write)


@register_scenario("row_buffer_friendly")
def row_buffer_friendly(n_banks, n_subarrays, reqs, rs, run_len: int = 16):
    """Long same-row runs per bank: almost every access is a row hit, so
    refresh cost shows up purely as closed rows (re-activates)."""
    arrive = _poisson_arrivals(rs, reqs, 2.0)
    n_runs = reqs // run_len + 1
    run_bank = rs.randint(0, n_banks, n_runs)
    run_row = rs.randint(0, N_ROWS, n_runs)
    idx = np.arange(reqs) // run_len
    bank, row = run_bank[idx], run_row[idx]
    is_write = rs.rand(reqs) < 0.10
    return _assemble("row_buffer_friendly", n_banks, n_subarrays,
                     arrive, bank, row, is_write)


@register_scenario("bank_camping")
def bank_camping(n_banks, n_subarrays, reqs, rs, hot_frac: float = 0.7):
    """Most traffic camps on two hot banks; the rest idle — easy pickings
    for out-of-order refresh, budget-edge pressure on the hot banks."""
    hot = rs.rand(reqs) < hot_frac
    bank = np.where(hot, rs.randint(0, 2, reqs),
                    rs.randint(0, n_banks, reqs))
    row = rs.randint(0, N_ROWS, reqs)
    bank, row = _locality(rs, bank.copy(), row, 0.40)
    arrive = _poisson_arrivals(rs, reqs, 3.0)
    is_write = rs.rand(reqs) < 0.20
    return _assemble("bank_camping", n_banks, n_subarrays,
                     arrive, bank, row, is_write)


@register_scenario("subarray_conflict_adversarial")
def subarray_conflict_adversarial(n_banks, n_subarrays, reqs, rs,
                                  refi_pb_ticks: int = 162):
    """Accesses chase the subarray the per-bank round-robin refresh counter
    targets next (counter ~ t / tREFI_pb), so SARP's same-subarray
    exception fires as often as possible. `refi_pb_ticks` approximates the
    32 Gb per-bank refresh cadence in ticks."""
    arrive = _poisson_arrivals(rs, reqs, 3.0)
    bank = rs.randint(0, n_banks, reqs)
    target_sub = (arrive // refi_pb_ticks) % n_subarrays
    # pick rows that land exactly on the refreshing subarray
    row = (target_sub + n_subarrays *
           rs.randint(0, N_ROWS // n_subarrays, reqs)) % N_ROWS
    is_write = rs.rand(reqs) < 0.15
    return _assemble("subarray_conflict_adversarial", n_banks, n_subarrays,
                     arrive, bank, row, is_write)


@register_scenario("mixed")
def mixed(n_banks, n_subarrays, reqs, rs):
    """The legacy `make_workload("mixed")` analogue: medium locality,
    30% writes, moderate pressure."""
    arrive = _poisson_arrivals(rs, reqs, 2.5)
    bank = rs.randint(0, n_banks, reqs)
    row = rs.randint(0, N_ROWS, reqs)
    bank, row = _locality(rs, bank, row, 0.50)
    is_write = rs.rand(reqs) < 0.30
    return _assemble("mixed", n_banks, n_subarrays,
                     arrive, bank, row, is_write)


@register_scenario("streaming")
def streaming(n_banks, n_subarrays, reqs, rs):
    """Bandwidth-bound: near back-to-back arrivals, high row locality,
    write-through third."""
    arrive = _poisson_arrivals(rs, reqs, 1.4)
    bank = rs.randint(0, n_banks, reqs)
    row = rs.randint(0, N_ROWS, reqs)
    bank, row = _locality(rs, bank, row, 0.85)
    is_write = rs.rand(reqs) < 0.33
    return _assemble("streaming", n_banks, n_subarrays,
                     arrive, bank, row, is_write)


@register_scenario("trace_replay")
def trace_replay(n_banks, n_subarrays, reqs, rs, trace=None):
    """Replay a DRAM command trace as the demand stream — the scenario
    face of `repro_torch.core.commands` (emit -> validate -> replay).

    `trace` may be a `repro_torch.core.commands.CmdTrace` (emitted by
    `run_ticks(record_commands=True)` or loaded via `CmdTrace.from_json`)
    whose RD/WR records become the open-loop arrivals, or the legacy
    dict of arrive/bank/row/is_write (and optionally sub) array-likes.

    Without one, a small `dsarp` source run on `closed_mixed` is
    captured through the real emission layer and replayed; its seed is
    drawn from `rs`, so the result is deterministic per (name, seed)
    like every other registered scenario, and `reqs` tiles the captured
    window to length."""
    from repro_torch.core.commands.trace import CmdTrace

    if trace is None:
        from repro_torch.core.refresh.sim import DramSim
        from repro_torch.core.refresh.timing import timing_for_density
        src_seed = int(rs.randint(0, 2 ** 31 - 1))
        wl = make_closed_workload("closed_mixed", 64, src_seed)
        res = DramSim(timing_for_density(32), wl, "dsarp").run_ticks(
            record_commands=True)
        cmds = [c for c in res.commands.cmds if c.op in ("RD", "WR")]
        m = res.commands.meta
        arrive = np.array([int(c.tick) for c in cmds])
        bank = np.array([(c.ch * m["n_ranks"] + c.rank) * m["n_banks"]
                         + c.bank for c in cmds])
        row = np.array([c.row for c in cmds])
        is_write = np.array([c.op == "WR" for c in cmds])
        base_n = len(cmds)
        reps = max(1, -(-reqs // base_n))
        span = int(arrive[-1]) + 16
        arrive = np.concatenate([arrive + r * span for r in range(reps)])
        trace = dict(arrive=arrive[:reqs], bank=np.tile(bank, reps)[:reqs],
                     row=np.tile(row, reps)[:reqs],
                     is_write=np.tile(is_write, reps)[:reqs])
    elif isinstance(trace, CmdTrace):
        m = trace.meta
        cmds = [c for c in trace.cmds if c.op in ("RD", "WR")]
        trace = dict(
            arrive=np.array([int(c.tick) for c in cmds]),
            bank=np.array([(c.ch * m["n_ranks"] + c.rank) * m["n_banks"]
                           + c.bank for c in cmds]),
            row=np.array([c.row for c in cmds]),
            is_write=np.array([c.op == "WR" for c in cmds]))
    return _assemble("trace_replay", n_banks, n_subarrays,
                     trace["arrive"], np.asarray(trace["bank"]) % n_banks,
                     np.asarray(trace["row"]) % N_ROWS, trace["is_write"],
                     sub=trace.get("sub"))


# ===================================================== closed-loop library
_CLOSED_SCENARIOS: Dict[str, Callable] = {}


@dataclass(frozen=True)
class ClosedDemand:
    """Closed-loop demand for one scenario: per-core request streams
    stacked as [n_cores, n_req] arrays, think gaps in integer ticks.

    `workload` is the generating `Workload` spec — hand it to `DramSim`
    (event or tick mode) and both simulators replay the same stream.
    """
    name: str
    workload: Workload          # the generator spec (shared with DramSim)
    is_write: np.ndarray        # [C, N] bool
    bank: np.ndarray            # [C, N] int32
    row: np.ndarray             # [C, N] int32
    sub: np.ndarray             # [C, N] int32
    think: np.ndarray           # [C, N] int32 ticks (>= 0)
    n_banks: int
    n_subarrays: int
    dt_ns: float

    @property
    def n_cores(self) -> int:
        return int(self.is_write.shape[0])

    @property
    def mlp(self) -> int:
        return int(self.workload.mlp)

    def __len__(self) -> int:
        return int(self.is_write.size)

    def validate(self) -> "ClosedDemand":
        C, N = self.is_write.shape
        assert C == self.workload.n_cores and C >= 1 and N >= 1
        assert self.workload.mlp >= 1
        for a in (self.bank, self.row, self.sub, self.think):
            assert a.shape == (C, N)
        assert (0 <= self.bank).all() and (self.bank < self.n_banks).all()
        assert (0 <= self.sub).all() and (self.sub < self.n_subarrays).all()
        assert (self.think >= 0).all()
        return self


def register_closed_scenario(name: str, fn: Callable = None, *,
                             override: bool = False):
    """Register a closed-loop scenario under `name`. The generator is
    called as `fn(reqs, seed)` — `reqs` is the total request budget across
    cores, `seed` an already-derived deterministic int — and must return a
    `workload.Workload`."""
    def deco(obj):
        if not override and name in _CLOSED_SCENARIOS:
            raise ValueError(
                f"closed scenario {name!r} is already registered; pass "
                f"override=True to replace it")
        _CLOSED_SCENARIOS[name] = obj
        return obj
    if fn is not None:
        return deco(fn)
    return deco


def list_closed_scenarios() -> list[str]:
    return sorted(_CLOSED_SCENARIOS)


def make_closed_workload(name: str, reqs: int = 800, seed: int = 0
                         ) -> Workload:
    """Resolve the named closed scenario to its `Workload` (the exact spec
    `make_closed_demand` quantizes — pass it to `DramSim` for the same
    demand stream). Deterministic per (name, seed), like `make_trace`."""
    try:
        fn = _CLOSED_SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown closed scenario {name!r}; registered: "
            f"{', '.join(sorted(_CLOSED_SCENARIOS))}") from None
    h = hashlib.sha256(f"closed:{name}:{seed}".encode()).digest()
    return fn(reqs, int.from_bytes(h[:4], "little"))


def make_closed_demand(name: str, n_banks: int = 8, n_subarrays: int = 8,
                       reqs: int = 800, seed: int = 0, dt_ns: float = 6.0
                       ) -> ClosedDemand:
    """Generate + tick-quantize the named closed scenario's demand (the
    span ``demand``)."""
    with trace.span("demand"):
        wl = make_closed_workload(name, reqs, seed)
        streams = quantize_streams(wl.generate(n_banks, n_subarrays), dt_ns)
        return ClosedDemand(
            name=name, workload=wl,
            is_write=np.stack([s["is_write"] for s in streams]),
            bank=np.stack([s["bank"] for s in streams]),
            row=np.stack([s["row"] for s in streams]),
            sub=np.stack([s["subarray"] for s in streams]),
            think=np.stack([s["think"] for s in streams]),
            n_banks=n_banks, n_subarrays=n_subarrays, dt_ns=dt_ns).validate()


def _closed_preset(preset: str, n_cores: int):
    def gen(reqs: int, seed: int) -> Workload:
        return make_workload(preset, n_cores=n_cores,
                             reqs_per_core=max(1, reqs // n_cores),
                             seed=seed)
    gen.__name__ = f"closed_{preset}"
    return gen


#: Closed-loop variants of the workload library, riding on the
#: `make_workload` presets `DramSim` has always consumed. Spanning the
#: MLP axis matters here: refresh hurts most when cores stall on every
#: miss (closed_low_mlp) and least when deep MLP hides it
#: (closed_streaming) — the paper's Figure 1/3 sensitivity.
register_closed_scenario("closed_mixed", _closed_preset("mixed", 4))
register_closed_scenario("closed_read_heavy", _closed_preset("read_heavy", 4))
register_closed_scenario("closed_write_heavy",
                         _closed_preset("write_heavy", 4))
register_closed_scenario("closed_low_mlp", _closed_preset("low_mlp", 4))
register_closed_scenario("closed_streaming", _closed_preset("streaming", 4))


@register_closed_scenario("closed_multirank")
def closed_multirank(reqs: int, seed: int) -> Workload:
    """Eight cores, medium MLP, low think time: enough concurrent demand
    that every rank of a multi-rank hierarchy sees traffic while one rank
    drains for REF_ab — the scenario the [channel, rank, bank] sweeps
    (`SweepSpec(n_ranks=...)`) use to show cross-rank refresh staggering.
    Bank indices are drawn over the GLOBAL bank space at generation time,
    so the same scenario scales with the configured hierarchy."""
    return Workload(name="multirank", n_cores=8, mlp=4, think_ns=10.0,
                    row_hit_rate=0.50, write_ratio=0.25,
                    reqs_per_core=max(1, reqs // 8), seed=seed)


@register_closed_scenario("closed_subarray_storm")
def closed_subarray_storm(reqs: int, seed: int) -> Workload:
    """High demand pressure with almost no row reuse: every access opens a
    new row, so rows (and their subarrays, drawn as `row % n_subarrays`)
    scatter across the whole bank. Under per-bank refresh this keeps a
    steady stream of accesses arriving AT banks that are mid-refresh —
    exactly where SARP's idle-sibling-subarray serving pays and non-SARP
    policies stall. The subarray conformance tier
    (`tests/test_subarray.py`) runs this at `n_subarrays` in {1, 4, 8}."""
    return Workload(name="subarray_storm", n_cores=8, mlp=4, think_ns=8.0,
                    row_hit_rate=0.05, write_ratio=0.20,
                    reqs_per_core=max(1, reqs // 8), seed=seed)


@register_closed_scenario("closed_subarray_locality")
def closed_subarray_locality(reqs: int, seed: int) -> Workload:
    """The opposite pole: high row locality, so the open-row state each
    subarray carries (`open_row_s`) is load-bearing — a refresh that
    closes one subarray's row must not disturb its siblings' hit streaks.
    Distinguishes per-subarray row buffers from a single per-bank one."""
    return Workload(name="subarray_locality", n_cores=4, mlp=4,
                    think_ns=12.0, row_hit_rate=0.75, write_ratio=0.15,
                    reqs_per_core=max(1, reqs // 4), seed=seed)


# ======================================================== serving library
_SERVING_SCENARIOS: Dict[str, Callable] = {}


@dataclass(frozen=True)
class ServingArrivals:
    """Request arrival process for the continuous-batching serving loop.

    Parallel arrays, one entry per request, sorted by `arrive_round`
    (stable, so same-round requests keep generation order — the FIFO
    tie-break the scheduler property tests replay). Rounds are
    `EngineCore.step_round` indices, not ticks: the co-sim owns the
    round -> tick clock.
    """
    name: str
    arrive_round: np.ndarray    # int64, non-decreasing, >= 0
    prompt_len: np.ndarray      # int64 >= 1 tokens
    max_new: np.ndarray         # int64 >= 1 decode budget
    priority: np.ndarray        # int64 >= 0, lower is more urgent

    def __len__(self) -> int:
        return int(self.arrive_round.shape[0])

    def validate(self) -> "ServingArrivals":
        n = len(self)
        assert n > 0
        for a in (self.prompt_len, self.max_new, self.priority):
            assert len(a) == n
        assert (np.diff(self.arrive_round) >= 0).all(), \
            "arrivals must be sorted by round"
        assert self.arrive_round[0] >= 0
        assert (self.prompt_len >= 1).all()
        assert (self.max_new >= 1).all()
        assert (self.priority >= 0).all()
        return self


def _assemble_serving(name, arrive, prompt_len, max_new,
                      priority=None) -> ServingArrivals:
    arrive = np.asarray(arrive, np.int64)
    order = np.argsort(arrive, kind="stable")
    n = len(arrive)
    if priority is None:
        priority = np.zeros(n, np.int64)
    return ServingArrivals(
        name, arrive[order],
        np.asarray(prompt_len, np.int64)[order],
        np.asarray(max_new, np.int64)[order],
        np.asarray(priority, np.int64)[order])


def register_serving_scenario(name: str, fn: Callable = None, *,
                              override: bool = False):
    """Register a serving arrival process under `name` (decorator or
    direct call). The generator is called as `fn(n, rs, **cfg)` and must
    return a `ServingArrivals`. Names start with ``serving_`` by
    convention — the registry-coverage pass keys its co-sim matrix rule
    (RC407) on that prefix."""
    def deco(obj):
        if not override and name in _SERVING_SCENARIOS:
            raise ValueError(
                f"serving scenario {name!r} is already registered; pass "
                f"override=True to replace it")
        _SERVING_SCENARIOS[name] = obj
        return obj
    if fn is not None:
        return deco(fn)
    return deco


def list_serving_scenarios() -> list[str]:
    return sorted(_SERVING_SCENARIOS)


def make_serving_arrivals(name: str, n_requests: int = 200, seed: int = 0,
                          **cfg) -> ServingArrivals:
    """Generate the named serving arrival process, deterministic per
    (name, seed) (KeyError lists known names)."""
    try:
        fn = _SERVING_SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown serving scenario {name!r}; registered: "
            f"{', '.join(sorted(_SERVING_SCENARIOS))}") from None
    h = hashlib.sha256(f"serving:{name}:{seed}".encode()).digest()
    rs = np.random.RandomState(int.from_bytes(h[:4], "little"))
    return fn(n_requests, rs, **cfg).validate()


def _geometric_prompts(rs, n: int, mean: float, lo: int, hi: int):
    return np.clip(rs.geometric(1.0 / mean, n), lo, hi).astype(np.int64)


@register_serving_scenario("serving_diurnal")
def serving_diurnal(n, rs, base_gap: float = 2.0, amp: float = 0.8,
                    cycles: float = 2.0):
    """Slow sinusoidal load swing (the day/night cycle compressed to one
    run): inter-arrival gaps stretch and shrink by `amp` around
    `base_gap` rounds over `cycles` full periods. Peaks back the
    admission queue up; troughs are the valleys SLO-aware policies repay
    refresh debt in."""
    phase = 2.0 * np.pi * cycles * np.arange(n) / max(1, n)
    mean_gap = base_gap * (1.0 + amp * np.sin(phase))
    gaps = rs.exponential(np.maximum(mean_gap, 0.05))
    arrive = np.floor(np.cumsum(gaps)).astype(np.int64)
    prompt = _geometric_prompts(rs, n, 8.0, 2, 24)
    max_new = _geometric_prompts(rs, n, 6.0, 2, 12)
    return _assemble_serving("serving_diurnal", arrive, prompt, max_new)


@register_serving_scenario("serving_bursty")
def serving_bursty(n, rs, burst: int = 12, quiet: int = 24,
                   burst_span: int = 3):
    """Dense request bursts separated by quiet valleys: `burst` requests
    land within `burst_span` rounds, then `quiet` rounds pass with no
    arrivals. The serving-side analogue of `write_burst_draining` — the
    quiet valleys are where DARP-style out-of-order refresh harvests
    idle banks, and the bursts are where all-bank refresh's full-rank
    stalls land on every request at once."""
    arrive, left, t = [], n, 0
    while left > 0:
        nb = min(burst, left)
        arrive.extend(t + rs.randint(0, burst_span, nb))
        left -= nb
        t += burst_span + quiet
    arrive = np.asarray(arrive, np.int64)
    prompt = _geometric_prompts(rs, n, 6.0, 2, 16)
    max_new = _geometric_prompts(rs, n, 5.0, 2, 10)
    return _assemble_serving("serving_bursty", arrive, prompt, max_new)


@register_serving_scenario("serving_heavy_tail")
def serving_heavy_tail(n, rs, mean_gap: float = 3.0, tail_alpha: float = 1.3,
                       n_classes: int = 3):
    """Poisson arrivals with a Pareto prompt-length mix (most prompts
    tiny, a heavy tail of long ones that monopolize prefill rounds) and
    `n_classes` priority classes — the mix that makes priority
    arbitration and chunked prefill earn their keep."""
    arrive = np.floor(np.cumsum(rs.exponential(mean_gap, n))).astype(np.int64)
    tail = np.ceil(rs.pareto(tail_alpha, n) * 4.0).astype(np.int64)
    prompt = np.clip(2 + tail, 2, 48)
    max_new = _geometric_prompts(rs, n, 5.0, 2, 12)
    priority = rs.randint(0, n_classes, n).astype(np.int64)
    return _assemble_serving("serving_heavy_tail", arrive, prompt,
                             max_new, priority)
