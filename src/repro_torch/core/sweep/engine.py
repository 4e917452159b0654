"""Batched scenario-sweep engine: (workload, policy, density) grids in
lock-step.

`DramSim` is the timing-fidelity oracle — an event-heap, per-request
Python loop that simulates ONE (workload, policy, density) point at a
time. The paper's headline claims, and every future policy PR, need the
*grid*: many scenarios x many policies x several densities. This engine
makes that grid cheap by hoisting the per-tick machine state (banks, bus,
write buffer, refresh ledger) into stacked ``[G, n_banks]`` arrays, where
``G`` is the number of grid cells, and advancing every cell one tick at a
time with vectorized numpy (policy decisions included — see
`sweep.policies`); the availability/arbitration inner step also has a
CUDA kernel (`repro_torch.kernels.sweep_arbiter`), and the whole tick
loop of each mode has one (`repro_torch.kernels.sweep_megakernel`).

This module is the PyTorch/CUDA port's copy of the JAX package's
`repro/core/sweep/engine.py`: the host side (`SweepSpec`, the numpy
`batched` and `scalar` backends of both modes) is carried over unchanged
and pinned equal to the original by the parity tests; `_Grid` keeps only
the original's per-scenario demand layout and is held column for column
to both of its layouts; `_finalize_cells` turns a whole grid's stat
columns into its cells in one vectorized pass, for every backend, and is
held bit for bit to the original's per-cell `_finalize`; the traced
backends are replaced by `backend="torch"` (a host loop over
`sweep.torchbody`) and `backend="mega"` (the CUDA tick-loop kernels, one
per mode). Both modes run on every backend.

Each call records the spans (`repro_torch.common.trace`) ``sweep`` ⊃
``sweep.grid`` ⊃ (``demand`` for each named scenario, ``sweep.grid.cells``:
the per-(policy, density) constants and their gather to the cells), and
on `mega` ``sweep.run`` and ``sweep.finalize``, whose durations are
also `SweepResult.seconds`.

State is stacked over GLOBAL banks: every cell carries a full
[channel, rank, bank] hierarchy (`SweepSpec.n_channels` x `n_ranks` x
`n_banks`), flattened to ``gb = (channel * n_ranks + rank) * n_banks +
bank`` so the state arrays are ``[G, n_banks_total]`` with rank/channel
id planes (`_Grid.rank_of_b` / `chan_of_b`). The default 1x1 hierarchy
reproduces the historical flat single-rank engine bit-for-bit.

One level further down, refresh occupancy and row-activation state are
SUBARRAY-granular: ``ref_until_s`` / ``open_row_s`` are stacked over
global subarrays, ``[G, n_banks_total * n_subarrays]`` with column
``gs = gb * S + sub``. A SARP refresh occupies (and closes the row of)
only its target subarray ``ctr % S``, so sibling-subarray accesses stay
eligible while it runs (at `SARP_PEN` extra latency, deprioritized by
the `W_NOCONF` score bit); a non-SARP refresh occupies every subarray of
the bank, blocking it whole. Policies with the `hra` trait (`hira`,
HiRA — hidden row activation) additionally start a per-bank refresh at
`t` when its target subarray differs from the in-flight access's
subarray, hiding the refresh activation behind the access instead of
waiting for the bank. With ``n_subarrays=1`` every one of these rules
degenerates to the bank-granular engine bit-for-bit.

Tick semantics (the contract every backend implements identically;
`docs/tick-contract.md` is the normative spec):

  * Time is an integer tick counter; one tick = `dt_ns` (default 6 ns =
    tBL, so each channel's data bus serializes to at most one request
    START per cell per channel per tick). All derived timings quantize
    via ``max(1, round(ns / dt_ns))`` — all-integer state means the
    scalar oracle, the batched numpy backend, the torch tick body and the
    CUDA kernels are **bit-identical**, not merely close.
  * Each tick, per active cell, in order:
      A. arrivals join their bank FIFO; pending-write count may trip the
         write-drain high watermark,
      B. all-bank refresh debt accrues every tREFI PER GLOBAL RANK for
         level='ab' policies, rank r's accrual staggered r * tREFI/R
         after rank 0's,
      C. the cell's policy decides maintenance against a MaintenanceView
         built from the stacked state (vectorized for the built-in policy
         classes, real `select()` for custom registrations), and the
         decisions are applied exactly like `DramSim`'s adapter
         (`_start_pb_refresh` / `_start_ab_refresh`); an all-bank start
         covers ONE rank and drains only that rank's banks,
      D. arbitration starts at most one eligible head-of-queue request
         PER CHANNEL, channels in ascending index order (drain-writes >
         occupancy > row hits > oldest; see `sweep.arbiter`). Scores are
         computed once per tick (the write-drain flag is snapshotted
         before any serve); each channel tracks its own read/write
         turnaround state, and switching ranks within a channel adds the
         tRTR rank-to-rank penalty,
      E. a cell deactivates once every request has been issued; its
         makespan is the completion tick of the last data burst.
  * Differences vs `DramSim`'s event-driven float mode, accepted for
    vectorizability and kept identical across backends: per-bank FIFO
    order (no FR-FCFS *reordering* within a bank — row-hit preference
    applies across banks), a symmetric read/write turnaround penalty
    folded into request latency, and read latencies clipped to
    `MAX_LAT_TICKS` in the p99 histogram.

Closed-loop mode (``SweepSpec(mode="closed")``) replaces the open-loop
arrival trace with `DramSim`'s MLP-limited multi-core front-end, on the
same tick contract (every backend, and `DramSim.run_ticks`, implements it
identically):

  * Demand comes from a `repro_torch.core.refresh.scenarios.ClosedDemand` —
    per-core request streams from the SAME `workload.Workload` generators
    `DramSim` consumes, think gaps quantized to ticks
    (`workload.quantize_streams`).
  * Each tick, per active cell, BEFORE the open-loop phases A-E:
      0. outstanding-read completions whose service finished at or before
         `t` retire: the issuing core's outstanding-window slot frees and
         its instruction-progress counter decrements,
      1. cores issue in core-index order, at most ONE request per core per
         tick: a core issues iff its think gap elapsed and (read: fewer
         than `mlp` reads outstanding | write: the shared write buffer is
         below `wbuf_cap`, first-come in core order). Issued requests
         append to the target bank's FIFO stamped with the issue tick;
         writes complete architecturally at issue (instruction progress),
         reads at data return.
  * A core finishes when its instruction count hits zero; the cell
    deactivates the tick its LAST core finishes (buffered writes may
    remain unserved, exactly like `DramSim.run` ending on core finish).
    `CellResult.core_finish` records per-core finish times, making
    `weighted_speedup_vs` — the paper's actual metric — well-defined.
  * Arbitration scoring additionally sees demand-side occupancy (per-bank
    queue depth, `W_OCC` field in `sweep.arbiter`): the most-backed-up
    eligible bank unblocks the most stalled cores. Open-loop runs keep the
    field at zero.

Backends:

  * ``backend="mega"`` — the CUDA tick-loop megakernels (one per mode),
    the default: one launch runs every cell to completion on the card.
  * ``backend="torch"`` — a host-driven loop over the torch tick body
    (`sweep.torchbody`), on the CPU or the card; `arbiter="cuda"` routes
    the scoring step through the CUDA arbiter kernel.
  * ``backend="batched"`` — stacked numpy, vectorized policies, host
    only. `arbiter="cuda"` routes step D's (closed: 5's) scoring through
    the CUDA arbiter kernel.
  * ``backend="scalar"`` — the reference oracle: a plain-Python
    per-cell tick loop that drives the *real* registered policy objects
    through `MaintenanceView`/`select()`. Slow by construction; exists so
    `tests/test_sweep.py` can demand bit-identical stats from the batched
    path for every registered policy.

    res = sweep(SweepSpec(policies=("ref_ab", "darp", "dsarp"),
                          scenarios=("read_heavy", "bank_camping"),
                          densities=(8, 32)))
    res.get("dsarp", "bank_camping", 32).avg_read_latency
    res.stat("energy")            # [n_policies, n_scenarios, n_densities]
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from itertools import product, repeat
from operator import itemgetter
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.common import trace
from repro_torch.core.policy import ALL_BANKS, MaintenanceView, resolve_policy
from repro_torch.core.refresh.scenarios import (ClosedDemand, Trace,
                                          make_closed_demand, make_trace)
from repro_torch.core.refresh.timing import timing_for_density
from repro_torch.core.sweep.arbiter import (AGE_CAP, OCC_CAP, W_HIT, W_NOCONF,
                                      W_OCC, W_WRITE, arbiter_scores,
                                      arbiter_scores_masked)
from repro_torch.core.sweep.policies import (KIND_AB, KIND_CUSTOM, KIND_IDEAL,
                                       KIND_STAG, classify, could_pick,
                                       select_batch)

#: read-latency histogram width (ticks); larger waits clip into the top bin
MAX_LAT_TICKS = 4095
_PAD_ARRIVE = np.int32(1 << 30)       # queue padding: never arrives


# ------------------------------------------------------------------ spec
@dataclass(frozen=True)
class TickTiming:
    """A `DramTiming` quantized to integer ticks of `dt_ns`.

    `REFI_PB` spreads tREFI uniformly over every bank in the hierarchy
    (n_channels x n_ranks x n_banks), so per-bank refresh phases — and
    hence whole ranks' refresh windows — stagger across ranks."""
    density_gb: int
    dt_ns: float
    REFI: int
    REFI_PB: int
    RFC_PB: int
    RFC_AB: int
    TRP: int                     # precharge-to-REF preamble gap
    HIT: int
    MISS: int
    WR: int
    TURN: int
    RTR: int                     # rank-to-rank bus turnaround
    SARP_PEN: int
    budget: int

    @classmethod
    def from_density(cls, density_gb: int, dt_ns: float = 6.0,
                     n_banks: int = 8, n_subarrays: int = 8,
                     n_ranks: int = 1, n_channels: int = 1) -> "TickTiming":
        return cls.from_dram(timing_for_density(
            density_gb, n_banks=n_banks, n_subarrays=n_subarrays,
            n_ranks=n_ranks, n_channels=n_channels), dt_ns)

    @classmethod
    def from_dram(cls, T, dt_ns: float = 6.0) -> "TickTiming":
        """`T` (a `DramTiming`) quantized to ticks of `dt_ns`."""
        def tk(ns: float) -> int:
            return max(1, int(ns / dt_ns + 0.5))

        refi = tk(T.tREFI)
        return cls(density_gb=T.density_gb, dt_ns=dt_ns, REFI=refi,
                   REFI_PB=max(1, refi // T.n_banks_total),
                   RFC_PB=tk(T.tRFC_pb),
                   RFC_AB=tk(T.tRFC_ab), TRP=tk(T.tRP), HIT=tk(T.row_hit),
                   MISS=tk(T.row_miss), WR=tk(T.tWR), TURN=tk(T.tWTR),
                   RTR=tk(T.tRTR), SARP_PEN=tk(T.sarp_penalty),
                   budget=T.refresh_budget)


@dataclass(frozen=True)
class SweepSpec:
    """One sweep grid: the cross product policies x scenarios x densities.

    One demand stream per (scenario, seed) is shared by every policy and
    density in the grid, so cells differ only in the axis under study.

    `mode="open"` consumes open-loop `Trace` scenarios; `mode="closed"`
    consumes closed-loop scenarios (`ClosedDemand` / names registered via
    `register_closed_scenario`) and runs the MLP-limited front-end — the
    configuration whose `weighted_speedup` matches the paper's metric.

    Pass policies as REGISTRY NAMES: every backend then resolves a fresh
    instance per cell, which is what keeps stateful policies (round-robin
    pointers in `ref_pb`/`staggered_ab`) bit-identical across backends.
    A policy INSTANCE on the axis is resolved as-is — its mutable state
    is shared across the scalar backend's cells (and across repeated
    sweeps), which the vectorized backends cannot mirror; instances are
    only safe on single-cell specs ("one policy instance drives exactly
    one engine run", `RefreshPolicy.select`).
    """
    policies: Sequence[str]
    scenarios: Sequence[Union[str, Trace, ClosedDemand]]
    densities: Sequence[int] = (8, 16, 32)
    reqs: int = 800
    seed: int = 0
    dt_ns: float = 6.0
    n_banks: int = 8             # banks PER RANK
    n_subarrays: int = 8
    n_ranks: int = 1             # ranks per channel
    n_channels: int = 1          # independent data buses
    wbuf_hi: int = 48            # pending-write drain high watermark
    wbuf_lo: int = 16            # drain low watermark
    wbuf_cap: int = 64           # write-buffer capacity (closed-loop issue
    #                              backpressure; open-loop traces ignore it)
    mode: str = "open"           # 'open' | 'closed'
    horizon: Optional[int] = None   # tick cap; None = auto

    def __post_init__(self):
        object.__setattr__(self, "policies", tuple(self.policies))
        object.__setattr__(self, "scenarios", tuple(self.scenarios))
        object.__setattr__(self, "densities", tuple(self.densities))
        if self.mode not in ("open", "closed"):
            raise ValueError(f"unknown sweep mode {self.mode!r}")

    @property
    def n_ranks_total(self) -> int:
        return self.n_ranks * self.n_channels

    @property
    def n_banks_total(self) -> int:
        return self.n_ranks_total * self.n_banks

    @property
    def shape(self) -> tuple[int, int, int]:
        return (len(self.policies), len(self.scenarios),
                len(self.densities))

    def cells(self) -> list[tuple]:
        """Grid cells in canonical (policy, scenario, density) order."""
        return list(product(self.policies, self.scenarios, self.densities))


@dataclass(frozen=True)
class CellResult:
    """Per-cell stats, field-compatible with the figure pipelines.

    `mode` records how the cell was produced: "open" (arrival trace) or
    "closed" (MLP-limited cores). `core_finish` (ns per core) and the
    weighted-speedup metrics exist only for closed cells — asking an
    open-loop cell for `weighted_speedup_vs` raises, because under
    open-loop arrivals the metric is meaningless (see docs/figures.md).
    """
    policy: str
    scenario: str
    density_gb: int
    makespan: float              # ns
    reads_done: int
    writes_done: int
    avg_read_latency: float      # ns
    p99_read_latency: float      # ns
    refreshes_pb: int
    refreshes_ab: int
    row_hits: int
    row_misses: int
    energy: float
    max_abs_lag: int
    finished: bool
    mode: str = "open"           # 'open' | 'closed'
    core_finish: tuple = ()      # per-core finish times (ns; closed only)

    def speedup_vs(self, ideal: "CellResult") -> float:
        """Makespan ratio. NOTE: under open-loop arrivals the makespan of
        an under-utilized cell converges to the arrival span for every
        policy — use `latency_speedup_vs` for refresh-degradation
        comparisons (the open-loop figure pipelines did, before the
        closed-loop mode landed `weighted_speedup_vs`)."""
        return ideal.makespan / self.makespan

    def latency_speedup_vs(self, ideal: "CellResult") -> float:
        """Open-loop analogue of the paper's weighted speedup: how much
        refresh inflates mean read latency vs the no-refresh ideal
        (<= 1.0 when this policy is worse)."""
        if self.avg_read_latency == 0.0:
            return 1.0
        return ideal.avg_read_latency / self.avg_read_latency

    def _require_closed(self, ideal: "CellResult", metric: str) -> None:
        for cell in (self, ideal):
            if cell.mode != "closed" or not cell.core_finish:
                raise ValueError(
                    f"{metric} is a closed-loop metric but the "
                    f"({cell.policy}, {cell.scenario}, {cell.density_gb}) "
                    f"cell was run mode={cell.mode!r}: open-loop arrivals "
                    "fix the demand timeline, so per-core progress ratios "
                    "are meaningless — rerun with SweepSpec(mode='closed') "
                    "or use latency_speedup_vs (docs/figures.md)")

    def per_core_slowdown_vs(self, ideal: "CellResult") -> tuple:
        """Per-core slowdown vs the no-refresh ideal (>= 1.0 means this
        policy finished that core later). Closed-loop cells only."""
        self._require_closed(ideal, "per_core_slowdown")
        return tuple(s / i if i > 0 else 1.0
                     for s, i in zip(self.core_finish, ideal.core_finish))

    def weighted_speedup_vs(self, ideal: "CellResult") -> float:
        """The paper's metric: mean over cores of
        finish_time(ideal) / finish_time(self). Closed-loop cells only
        (open-loop cells raise — see `_require_closed`)."""
        self._require_closed(ideal, "weighted_speedup")
        ratios = [i / s for i, s in zip(ideal.core_finish, self.core_finish)
                  if s > 0]
        return float(np.mean(ratios)) if ratios else 1.0


class SweepResult:
    """Results of one grid run, indexable by name or as [P, S, D] arrays."""

    def __init__(self, spec: SweepSpec, cells: list[CellResult],
                 backend: str):
        self.spec = spec
        self.cells = cells
        self.backend = backend
        self._by_key = {(c.policy, c.scenario, c.density_gb): c
                        for c in cells}
        #: per-cell DFI command traces, keyed (policy, scenario, density);
        #: populated only by `sweep(..., record_commands=True)`
        self.commands = None
        #: wall seconds of the megakernel backend's stages (grid build,
        #: device run, finalize); None for the other backends
        self.seconds = None

    def get(self, policy: str, scenario: str, density: int) -> CellResult:
        return self._by_key[(policy, _scenario_name(scenario), density)]

    def commands_for(self, policy: str, scenario: str, density: int):
        """The cell's emitted `CmdTrace` (record_commands sweeps only)."""
        if self.commands is None:
            raise ValueError(
                "this sweep did not record command traces; rerun with "
                "sweep(spec, record_commands=True)")
        return self.commands[(policy, _scenario_name(scenario), density)]

    def stat(self, name: str) -> np.ndarray:
        """One stat as a [n_policies, n_scenarios, n_densities] array."""
        P, S, D = self.spec.shape
        return np.array([getattr(c, name) for c in self.cells]
                        ).reshape(P, S, D)

    def __iter__(self):
        return iter(self.cells)


def _scenario_name(s) -> str:
    return s.name if isinstance(s, (Trace, ClosedDemand)) else s


# ------------------------------------------------------------------ grid
#: the `TickTiming` columns every cell carries, taken from its density
_TICK_COLS = ("REFI", "REFI_PB", "RFC_PB", "RFC_AB", "TRP", "HIT", "MISS",
              "WR", "TURN", "RTR", "SARP_PEN", "budget")


class _Grid:
    """Spec unpacked into per-cell constants and per-scenario demand.

    The one place that knows the canonical cell order (policy, scenario,
    density; density innermost): `pol_of`, `scn_of_cell` and `den_of`
    are a cell's policy position, its index in `scn_names` (the keys of
    `demands` / `traces`) and its density's last axis position. Timing
    is built once a density (`timing`, and the `DramTiming` it quantizes
    in `dram`), policies once a (policy, density) pair; every `[G]`,
    `[G, B]` and `[G, R]` column is one gather from those tables.

    Demand is kept once a scenario, `scn_*` planes (closed: per-core
    streams `[NS, C, N]`, `scn_nreq [NS, C]`; open: per-bank arrival
    FIFOs `[NS, B, L]`, `scn_npb [NS, B]`): a 10^5-cell grid carries
    `n_scenarios` stream copies, and a backend that wants its cells'
    rows gathers them with ``plane[grid.scn_of_cell]``.

    `stack_streams` is accepted and ignored: a caller outside the
    package still passes it."""

    def __init__(self, spec: SweepSpec, stack_streams: bool = True):
        if not (spec.policies and spec.scenarios and spec.densities):
            raise ValueError(
                "sweep() needs at least one policy, scenario, and density "
                f"(got {len(spec.policies)} policies, "
                f"{len(spec.scenarios)} scenarios, "
                f"{len(spec.densities)} densities); a spec built only to "
                "share one axis with another tool cannot be swept itself")
        self.spec = spec
        self.cells = spec.cells()
        G, B = len(self.cells), spec.n_banks_total
        self.G, self.B, self.S = G, B, spec.n_subarrays
        # hierarchy planes: global bank gb -> global rank / channel
        self.NB, self.NR, self.NC = spec.n_banks, spec.n_ranks, spec.n_channels
        self.R = spec.n_ranks_total
        self.rank_of_b = np.arange(B, dtype=np.int32) // self.NB
        self.chan_of_b = np.arange(B, dtype=np.int32) // (self.NR * self.NB)
        self.rank_of_t = tuple(int(x) for x in self.rank_of_b)
        self.chan_of_t = tuple(int(x) for x in self.chan_of_b)
        self.closed = spec.mode == "closed"

        if self.closed:
            self.demands = {}
            for s in spec.scenarios:
                if isinstance(s, Trace):
                    raise ValueError(
                        f"scenario {s.name!r} is an open-loop Trace but the "
                        "spec has mode='closed'; pass a closed scenario "
                        "name or a ClosedDemand")
                self.demands[_scenario_name(s)] = (
                    s if isinstance(s, ClosedDemand) else
                    make_closed_demand(s, B, spec.n_subarrays, spec.reqs,
                                       spec.seed, spec.dt_ns))
            self.scn_names = list(self.demands)
            self._closed_planes(list(self.demands.values()))
        else:
            self.traces = {}
            for s in spec.scenarios:
                if isinstance(s, ClosedDemand):
                    raise ValueError(
                        f"scenario {s.name!r} is a closed-loop ClosedDemand "
                        "but the spec has mode='open'; pass "
                        "SweepSpec(mode='closed')")
                self.traces[_scenario_name(s)] = (
                    s if isinstance(s, Trace) else
                    make_trace(s, B, spec.n_subarrays, spec.reqs, spec.seed))
            self.scn_names = list(self.traces)
            self._open_planes(list(self.traces.values()))

        # cell ids by position in the canonical order; a scenario maps
        # through its name and a density through its value, once an entry
        pol, scn, den = np.indices(spec.shape, dtype=np.int32).reshape(3, G)
        s_id = {n: i for i, n in enumerate(self.scn_names)}
        d_id = {d: k for k, d in enumerate(spec.densities)}
        self.pol_of = pol
        self.scn_of_cell = np.array(
            [s_id[_scenario_name(s)] for s in spec.scenarios], np.int32)[scn]
        self.den_of = np.array([d_id[d] for d in spec.densities],
                               np.int32)[den]

        self.dram = {d: timing_for_density(
            d, n_banks=spec.n_banks, n_subarrays=spec.n_subarrays,
            n_ranks=spec.n_ranks, n_channels=spec.n_channels)
            for d in spec.densities}
        self.timing = {d: TickTiming.from_dram(T, spec.dt_ns)
                       for d, T in self.dram.items()}

        with trace.span("sweep.grid.cells"):
            self._cell_constants()
            if self.closed:
                self.n_req_c = self.scn_nreq[self.scn_of_cell]
                self.mlp_g = self.scn_mlp[self.scn_of_cell]
                self.n_tot = self.n_req_c.sum(axis=1)
            else:
                self.n_per_bank = self.scn_npb[self.scn_of_cell]
                self.n_tot = self.n_per_bank.sum(axis=1)

        svc = int(self.MISS.max() + self.WR.max() + self.TURN.max() + 2)
        if self.closed:
            # ring queues: occupancy is bounded by outstanding reads
            # (C * mlp) + buffered writes (wbuf_cap)
            need = self.C * int(self.K) + spec.wbuf_cap + 1
            self.LQ = 1 << max(1, (need - 1).bit_length())
            think_span = int(self.scn_think.sum(axis=2).max())
            auto = (think_span + 4 * int(self.n_tot.max()) * svc
                    + 8 * int(self.RFC_AB.max()) + 64)
        else:
            max_arrive = max(int(tr.arrive[-1])
                             for tr in self.traces.values())
            auto = (max_arrive + 4 * int(self.n_tot.max()) * svc
                    + 8 * int(self.RFC_AB.max()) + 64)
        self.horizon = spec.horizon if spec.horizon else min(auto, 1 << 28)

    def _closed_planes(self, dems: list) -> None:
        """Each scenario's per-core streams, padded to the grid's (C, N)
        maximum."""
        NS = len(dems)
        self.C = C = max(dem.n_cores for dem in dems)
        self.N = N = max(int(dem.is_write.shape[1]) for dem in dems)
        self.K = max(dem.mlp for dem in dems)
        self.scn_write = np.zeros((NS, C, N), bool)
        self.scn_bank = np.zeros((NS, C, N), np.int32)
        self.scn_row = np.zeros((NS, C, N), np.int32)
        self.scn_sub = np.zeros((NS, C, N), np.int32)
        self.scn_think = np.zeros((NS, C, N), np.int32)
        self.scn_nreq = np.zeros((NS, C), np.int32)
        self.scn_mlp = np.array([dem.mlp for dem in dems], np.int32)
        for i, dem in enumerate(dems):
            c, n = dem.is_write.shape
            self.scn_write[i, :c, :n] = dem.is_write
            self.scn_bank[i, :c, :n] = dem.bank
            self.scn_row[i, :c, :n] = dem.row
            self.scn_sub[i, :c, :n] = dem.sub
            self.scn_think[i, :c, :n] = dem.think
            self.scn_nreq[i, :c] = n

    def _open_planes(self, traces: list) -> None:
        """Each scenario's per-bank arrival FIFOs, padded to the longest."""
        NS, B = len(traces), self.B
        masks = [[tr.bank == b for b in range(B)] for tr in traces]
        self.scn_npb = np.array([[m.sum() for m in ms] for ms in masks],
                                np.int32).reshape(NS, B)
        self.L = L = max(1, int(self.scn_npb.max()))
        self.scn_qa = np.full((NS, B, L), _PAD_ARRIVE, np.int32)
        self.scn_qr = np.zeros((NS, B, L), np.int32)
        self.scn_qs = np.zeros((NS, B, L), np.int32)
        self.scn_qw = np.zeros((NS, B, L), bool)
        for i, (tr, ms) in enumerate(zip(traces, masks)):
            for b, m in enumerate(ms):
                n = self.scn_npb[i, b]
                self.scn_qa[i, b, :n] = tr.arrive[m]
                self.scn_qr[i, b, :n] = tr.row[m]
                self.scn_qs[i, b, :n] = tr.sub[m]
                self.scn_qw[i, b, :n] = tr.is_write[m]

    def cell_streams(self) -> dict:
        """Each cell's demand gathered from its scenario's planes, as flat
        per-cell rows: open ``qa qr qs qw`` ``[G*B, L]``, closed ``sw sb
        sr ssub sth`` ``[G*C, N]``."""
        if self.closed:
            planes = dict(sw=self.scn_write, sb=self.scn_bank,
                          sr=self.scn_row, ssub=self.scn_sub,
                          sth=self.scn_think)
        else:
            planes = dict(qa=self.scn_qa, qr=self.scn_qr, qs=self.scn_qs,
                          qw=self.scn_qw)
        return {k: v[self.scn_of_cell].reshape(-1, v.shape[-1])
                for k, v in planes.items()}

    def _cell_constants(self) -> None:
        """Policy constants in `[P, D]` tables (one `resolve_policy` a
        policy, one `classify` a (policy, density) pair) and timing in
        `[D]` tables, then every per-cell column by one gather. A
        `KIND_CUSTOM` cell gets an instance of its own in `customs`: the
        batched backend drives it, state and all, one cell at a time."""
        spec = self.spec
        P, _, D = spec.shape
        tks = [self.timing[d] for d in spec.densities]      # by den_of
        tick = {f: np.array([getattr(tk, f) for tk in tks], np.int32)
                for f in _TICK_COLS}
        kind = np.zeros((P, D), np.int32)
        urgent_at = np.ones((P, D), np.int32)
        trait = {f: np.zeros((P, D), bool)
                 for f in ("level_ab", "sarp", "hra", "wrp")}
        for i, p in enumerate(spec.policies):
            pol = resolve_policy(p)
            for k in range(D):
                kind[i, k], params = classify(pol, tks[k].budget)
                urgent_at[i, k] = params.get("urgent_at", 1)
                trait["level_ab"][i, k] = (not pol.ideal) and pol.level == "ab"
                trait["sarp"][i, k] = pol.sarp
                trait["hra"][i, k] = bool(getattr(pol, "hra", False))
                trait["wrp"][i, k] = params.get("wrp", False)

        pd = (self.pol_of, self.den_of)
        self.kind, self.urgent_at = kind[pd], urgent_at[pd]
        for f, table in trait.items():
            setattr(self, f, table[pd])
        for f, col in tick.items():
            setattr(self, f, col[self.den_of])
        # per-bank refresh phases, and per-(cell, global rank) all-bank
        # debt accrual phases: rank r's debt lands r * tREFI/R after
        # rank 0's (cross-rank staggering)
        self.phase = (tick["REFI_PB"][:, None]
                      * np.arange(self.B, dtype=np.int32))[self.den_of]
        self.rank_phase = ((tick["REFI"] // self.R)[:, None]
                           * np.arange(self.R, dtype=np.int32))[self.den_of]
        self.customs: list[tuple[int, object]] = [
            (g, resolve_policy(spec.policies[self.pol_of[g]]))
            for g in np.flatnonzero(self.kind == KIND_CUSTOM).tolist()]
        self.has_stag = bool((self.kind == KIND_STAG).any())
        self.has_hra = bool(self.hra.any())


# ----------------------------------------------------------- finalization
def _refreshing_subs(ru_bank_sub: np.ndarray, t: int) -> tuple:
    """Per-bank currently-refreshing subarray for `MaintenanceView`
    (input is one cell's [B, S] ref_until plane): the single mid-refresh
    subarray if exactly one is occupied (a SARP per-subarray refresh),
    else -1 (idle bank, or a whole-bank refresh)."""
    mid = ru_bank_sub > t
    n_mid = mid.sum(axis=1)
    first = np.argmax(mid, axis=1)
    return tuple(int(f) if n == 1 else -1 for f, n in zip(first, n_mid))


def _scalar_refreshing_sub(ru_subs, t: int) -> int:
    """`_refreshing_subs` for one bank's plain-list state (scalar oracle
    and `DramSim.run_ticks` keep per-bank lists, not planes)."""
    mid = [i for i, ru in enumerate(ru_subs) if ru > t]
    return mid[0] if len(mid) == 1 else -1


def _p99_ticks(hist_row: np.ndarray, n_reads: int) -> int:
    if n_reads <= 0:
        return 0
    target = math.ceil(0.99 * n_reads)
    return int(np.searchsorted(np.cumsum(hist_row), target, side="left"))


def _finalize_cells(grid: _Grid, *, reads, writes, hits, misses, refpb,
                    refab, lat_sum, maxlag, last_done, finished,
                    core_finish=None, p99=None, hist=None,
                    index=None) -> list[CellResult]:
    """Integer machine stat columns -> CellResults, every cell in one
    vectorized pass. Shared by every backend (and mirrored by
    `DramSim.run_ticks`) so the derived floats are bit-identical whenever
    the integers are: each is the same IEEE operations, in the same
    order, as `DramSim`'s scalar expression, and `energy_proxy` serves
    both.

    The columns are `[G]` (`core_finish` `[G, C]`, `hist` `[G, H]`) in
    canonical cell order, or one row for each cell index in `index`.
    `core_finish` (per-core finish ticks) switches the cells to
    closed-loop accounting: makespan becomes the last of the scenario's
    cores to finish instead of the last data burst. `p99` (the p99 tick
    index, already reduced from the histogram — the megakernel computes
    it in-kernel and never ships the [4096] rows home) stands in for
    `hist`."""
    from repro_torch.core.refresh.sim import energy_proxy
    spec = grid.spec
    dt = spec.dt_ns
    g = (np.arange(grid.G, dtype=np.int64) if index is None
         else np.asarray(index, np.int64))
    d_of, s_of = grid.den_of[g], grid.scn_of_cell[g]
    reads, writes, hits, misses, refpb, refab, lat_sum, maxlag = (
        np.asarray(a).astype(np.int64) for a in
        (reads, writes, hits, misses, refpb, refab, lat_sum, maxlag))
    if core_finish is None:
        mode, cf = "open", [()] * len(g)
        makespan = np.asarray(last_done).astype(np.float64) * dt
    else:
        mode = "closed"
        # backends pass [grid.C] rows; keep the scenario's real cores only
        fin = np.asarray(core_finish).astype(np.int64)
        nc = np.array([dem.n_cores for dem in grid.demands.values()])[s_of]
        # finish ticks are non-negative: 0 in the other columns keeps
        # the real cores' max
        real = np.arange(fin.shape[1], dtype=np.int64) < nc[:, None]
        last = np.where(real, fin, 0).max(axis=1)
        makespan = last.astype(np.float64) * dt
        cf = [tuple(row[:n]) for row, n in
              zip((fin.astype(np.float64) * dt).tolist(), nc.tolist())]
    some = reads != 0
    avg = np.where(some, (dt * lat_sum.astype(np.float64))
                   / np.where(some, reads, 1).astype(np.float64), 0.0)
    if p99 is None:
        p99 = [_p99_ticks(h, r) for h, r in zip(hist, reads.tolist())]
    p99_lat = dt * np.asarray(p99).astype(np.float64)
    energy = np.empty(len(g), np.float64)
    for k in np.unique(d_of).tolist():
        m = d_of == k
        energy[m] = energy_proxy(grid.dram[spec.densities[k]], makespan[m],
                                 reads[m], writes[m], misses[m], refpb[m],
                                 refab[m])
    cells = grid.cells if index is None else [grid.cells[i] for i in g]
    # positional, in CellResult's field order: a call without keywords
    # costs a quarter less, a cell at a time
    return list(map(
        CellResult, map(itemgetter(0), cells),
        map(grid.scn_names.__getitem__, s_of.tolist()),
        map(itemgetter(2), cells),
        makespan.tolist(), reads.tolist(), writes.tolist(), avg.tolist(),
        p99_lat.tolist(), refpb.tolist(), refab.tolist(), hits.tolist(),
        misses.tolist(), energy.tolist(), maxlag.tolist(),
        np.asarray(finished).astype(bool).tolist(), repeat(mode), cf))


def _stat_columns(out: dict) -> dict:
    """The `[G]` integer stat columns of a tensor backend's output that
    `_finalize_cells` takes as they are."""
    return {k: out[k] for k in ("reads", "writes", "hits", "misses",
                                "refpb", "refab", "lat_sum", "maxlag",
                                "last_done")}


def _finalize(grid: _Grid, g: int, *, reads, writes, hits, misses, refpb,
              refab, lat_sum, hist, maxlag, last_done, finished,
              core_finish=None, p99=None) -> CellResult:
    """Cell `g`'s `_finalize_cells`, from its scalar stats (the scalar
    backends); `hist` may be None when `p99` is given."""
    row = lambda v: None if v is None else np.asarray(v)[None]
    return _finalize_cells(
        grid, index=[g], reads=row(reads), writes=row(writes),
        hits=row(hits), misses=row(misses), refpb=row(refpb),
        refab=row(refab), lat_sum=row(lat_sum), maxlag=row(maxlag),
        last_done=row(last_done), finished=row(finished),
        core_finish=row(core_finish), p99=row(p99), hist=row(hist))[0]


# --------------------------------------------------------- batched backend
def _run_batched(grid: _Grid, arbiter: str = "numpy",
                 device=None) -> list[CellResult]:
    spec = grid.spec
    G, B, L, S = grid.G, grid.B, grid.L, grid.S
    NB, R, NC = grid.NB, grid.R, grid.NC
    RBC = grid.NR * NB               # banks per channel
    HI, LO = spec.wbuf_hi, spec.wbuf_lo

    score_fn = None
    if arbiter == "cuda":
        from repro_torch.kernels.sweep_arbiter import make_arbiter
        score_fn = make_arbiter(G, B, device)
    elif arbiter != "numpy":
        raise ValueError(f"unknown arbiter {arbiter!r}")

    # each cell's arrival FIFOs as flat [G*B, L] planes for single-op
    # queue gathers
    qa, qr, qs, qw = grid.cell_streams().values()
    n_pb_flat = grid.n_per_bank.reshape(G * B)

    # machine state, stacked [G, B]; refresh occupancy and open rows are
    # subarray-granular, [G, B * S] with column gs = bank * S + sub
    bank_free = np.zeros((G, B), np.int32)
    ref_until_s = np.zeros((G, B * S), np.int32)
    open_row_s = np.full((G, B * S), -1, np.int32)
    open_sub = np.full((G, B), -1, np.int32)
    ctr = np.zeros((G, B), np.int32)
    issued = np.zeros((G, B), np.int32)
    n_arrived = np.zeros((G, B), np.int32)
    n_served = np.zeros((G, B), np.int32)
    rr = np.zeros(G, np.int32)
    ab_rr = np.zeros(G, np.int32)          # staggered_ab rank pointer
    wpend = np.zeros(G, np.int32)
    drain = np.zeros(G, bool)
    last_op = np.zeros((G, NC), bool)      # per-channel bus turnaround
    last_rank = np.full((G, NC), -1, np.int32)
    ab_pending = np.zeros((G, R), np.int32)
    rank_drain = np.zeros((G, R), bool)
    active = grid.n_tot > 0
    n_left = grid.n_tot.astype(np.int64).copy()
    kind_active = np.where(active, grid.kind, KIND_IDEAL)
    has_ab = bool(grid.level_ab.any())

    # incrementally-maintained next-arrival and head-of-queue mirrors
    # (copies: qa[:, 0] is a strided view, and these are written)
    next_arrive = qa[:, 0].reshape(G, B).copy()
    next_w = qw[:, 0].reshape(G, B).copy()
    h_arr, h_row = next_arrive.copy(), qr[:, 0].reshape(G, B).copy()
    h_sub, h_w = qs[:, 0].reshape(G, B).copy(), next_w.copy()

    # stats
    reads = np.zeros(G, np.int64)
    writes = np.zeros(G, np.int64)
    hits = np.zeros(G, np.int64)
    misses = np.zeros(G, np.int64)
    refpb = np.zeros(G, np.int64)
    refab = np.zeros(G, np.int64)
    lat_sum = np.zeros(G, np.int64)
    hist = np.zeros((G, MAX_LAT_TICKS + 1), np.int32)
    maxlag = np.zeros(G, np.int32)
    last_done = np.zeros(G, np.int32)

    phase, REFI_col = grid.phase, grid.REFI[:, None]
    RFC_PB_col = grid.RFC_PB[:, None]
    sarp_c = grid.sarp[:, None]
    hra_c = grid.hra[:, None]
    sub_of_col = np.tile(np.arange(S, dtype=np.int32), B)[None, :]
    kind_g = grid.kind
    budget_g, wrp_g, urgent_g = grid.budget, grid.wrp, grid.urgent_at
    level_ab = grid.level_ab
    rank_phase_g = grid.rank_phase          # [G, R] accrual stagger
    #: ticks where SOME ab cell's rank accrues debt: (REFI, phase) pairs
    accrual_keys = sorted({(int(grid.REFI[g]), int(p))
                           for g in np.nonzero(level_ab)[0]
                           for p in grid.rank_phase[g]})
    has_drain_block = has_ab or bool(grid.customs)
    nav = next_arrive.ravel()
    nwv = next_w.ravel()
    arG = np.arange(G, dtype=np.int64)   # fancy-index helper, not a plane
    t = 0
    alive = int(active.sum())
    while alive and t < grid.horizon:
        # ---- A: arrivals (one queue slot per iteration handles bursts)
        while True:
            can = next_arrive <= t
            if not can.any():
                break
            wpend += (can & next_w).sum(axis=1)
            n_arrived += can
            gf = np.nonzero(can.ravel())[0]
            slot = n_arrived.ravel()[gf]
            sl = np.minimum(slot, L - 1)
            nav[gf] = np.where(slot >= n_pb_flat[gf], _PAD_ARRIVE,
                               qa[gf, sl])
            nwv[gf] = qw[gf, sl]
        drain |= wpend >= HI

        # ---- B: per-rank refresh debt for all-bank policies (rank r
        # accrues r * tREFI/R after rank 0 — cross-rank staggering)
        if has_ab and any(t > p and (t - p) % rv == 0
                          for rv, p in accrual_keys):
            acc = ((active & level_ab)[:, None]
                   & (t > rank_phase_g)
                   & ((t - rank_phase_g) % REFI_col == 0))
            ab_pending += acc
            rank_drain |= acc

        # ---- C: policy decisions against the stacked view
        # due = 0 while t < phase; phase < tREFI, so the floor-div form is
        # exact without the explicit branch
        due = np.maximum((t - phase) // REFI_col + 1, 0)
        lag = due - issued
        demand = n_arrived - n_served
        ready = (ref_until_s.reshape(G, B, S) <= t).all(axis=2)
        idle = bank_free <= t
        need = could_pick(kind=kind_active, lag=lag, demand=demand,
                          write_window=drain, budget=budget_g, wrp=wrp_g)
        picks = None
        if need.any():
            picks, rr = select_batch(
                np, kind=np.where(need, kind_active, KIND_IDEAL), lag=lag,
                ready=ready, idle=idle, demand=demand, write_window=drain,
                budget=budget_g, wrp=wrp_g, urgent_at=urgent_g, rr=rr,
                gate=True, nb=NB)
            if not picks.any():
                picks = None

        start_ab_r = None
        if has_ab:
            quiet_r = (idle.reshape(G, R, NB).all(axis=2)
                       & ready.reshape(G, R, NB).all(axis=2))
            pend = (active & (kind_g == KIND_AB))[:, None] & (ab_pending > 0)
            if pend.any():
                start_ab_r = pend & quiet_r
            if grid.has_stag:       # staggered_ab: rank round-robin
                is_st = active & (kind_g == KIND_STAG)
                idx = ab_rr % R
                chan_ready = ready.reshape(G, NC, RBC).all(axis=2)
                elig = (is_st & (ab_pending[arG, idx] > 0)
                        & quiet_r[arG, idx]
                        & chan_ready[arG, idx // grid.NR])
                if elig.any():
                    if start_ab_r is None:
                        start_ab_r = np.zeros((G, R), bool)
                    start_ab_r[arG[elig], idx[elig]] = True
                ab_rr = ab_rr + elig

        for g, pol in grid.customs:          # non-vectorizable registrations
            if not active[g]:
                continue
            if pol.level == "ab":
                if ab_pending[g].sum() <= 0:
                    continue
                quiet_g = bool(idle[g].all() and ready[g].all())
                view = MaintenanceView(
                    now=float(t), n_banks=B, budget=int(grid.budget[g]),
                    lag=[0] * B, demand=[0] * B,
                    ready=ready[g].tolist(), idle=idle[g].tolist(),
                    write_window=bool(drain[g]),
                    max_issues=1, rank_due=int(ab_pending[g].sum()),
                    rank_quiet=quiet_g,
                    n_ranks=grid.NR, n_channels=NC,
                    rank_of=grid.rank_of_t, channel_of=grid.chan_of_t,
                    ranks_due=tuple(int(x) for x in ab_pending[g]),
                    n_subarrays=S,
                    next_ref_sub=tuple(int(x) % S for x in ctr[g]),
                    refreshing_sub=_refreshing_subs(
                        ref_until_s[g].reshape(B, S), t),
                    active_sub=tuple(int(x) for x in open_sub[g]))
                for dec in pol.select(view):
                    if dec.bank == ALL_BANKS:
                        if start_ab_r is None:
                            start_ab_r = np.zeros((G, R), bool)
                        if dec.rank >= 0:
                            # debt-free ranks skipped (no negative debt)
                            if ab_pending[g, dec.rank] > 0:
                                start_ab_r[g, dec.rank] = True
                        else:
                            start_ab_r[g] |= ab_pending[g] > 0
            else:
                view = MaintenanceView(
                    now=float(t), n_banks=B, budget=int(grid.budget[g]),
                    lag=lag[g].tolist(), demand=demand[g].tolist(),
                    ready=ready[g].tolist(), idle=idle[g].tolist(),
                    write_window=bool(drain[g]), max_issues=1,
                    n_ranks=grid.NR, n_channels=NC,
                    rank_of=grid.rank_of_t, channel_of=grid.chan_of_t,
                    n_subarrays=S,
                    next_ref_sub=tuple(int(x) % S for x in ctr[g]),
                    refreshing_sub=_refreshing_subs(
                        ref_until_s[g].reshape(B, S), t),
                    active_sub=tuple(int(x) for x in open_sub[g]))
                for dec in pol.select(view):
                    if dec.bank == ALL_BANKS:
                        raise ValueError(
                            f"policy {pol.name!r} returned ALL_BANKS from "
                            f"a per-bank (level='pb') decision point")
                    if picks is None:
                        picks = np.zeros((G, B), bool)
                    picks[g, dec.bank] = True

        if start_ab_r is not None and start_ab_r.any():
            m = np.repeat(start_ab_r, NB, axis=1)
            new_sub = (ctr % S).astype(np.int32)
            # SARP marks (and closes) only the target subarray ctr % S;
            # a non-SARP refresh occupies every subarray of the bank
            mark = (np.repeat(m, S, axis=1)
                    & np.where(sarp_c, np.repeat(new_sub, S, axis=1)
                               == sub_of_col, True))
            ref_until_s = np.where(mark, (t + grid.RFC_AB)[:, None],
                                   ref_until_s)
            open_row_s = np.where(mark, -1, open_row_s)
            ctr = ctr + (m & sarp_c)
            ab_pending -= start_ab_r
            rank_drain = np.where(start_ab_r, ab_pending > 0, rank_drain)
            refab += start_ab_r.sum(axis=1)

        if picks is not None:
            new_sub = (ctr % S).astype(np.int32)
            # HiRA hidden row activation: when the refresh targets a
            # subarray the in-flight access is NOT using, start it at t —
            # overlapping the access — instead of waiting for the bank
            # (inert at S=1: the lone subarray matches open_sub once any
            # access has been served, and bank_free <= t before then)
            start = np.maximum(t, bank_free)
            start = np.where(hra_c & (new_sub != open_sub), t, start)
            mark = (np.repeat(picks, S, axis=1)
                    & np.where(sarp_c, np.repeat(new_sub, S, axis=1)
                               == sub_of_col, True))
            ref_until_s = np.where(
                mark, np.repeat(start + RFC_PB_col, S, axis=1), ref_until_s)
            open_row_s = np.where(mark, -1, open_row_s)
            ctr = ctr + picks
            issued = issued + picks
            refpb += picks.sum(axis=1)
            lag_after = due - issued
            maxlag = np.maximum(
                maxlag, np.where(picks, np.abs(lag_after), 0).max(axis=1))

        # ---- D: arbitration — at most one request start per channel
        # (the head request's own subarray's refresh/open-row state is
        # gathered from the post-refresh [G, B*S] planes, so the arbiter
        # stays a flat [G, B] step; scores — incl. the drain flag — are
        # snapshotted before any serve)
        has_req = demand > 0
        if not has_req.any():
            t += 1
            continue
        rank_drain_b = np.repeat(rank_drain, NB, axis=1)
        ru3 = ref_until_s.reshape(G, B, S)
        head_ru = np.take_along_axis(ru3, h_sub[:, :, None], 2)[:, :, 0]
        head_or = np.take_along_axis(
            open_row_s.reshape(G, B, S), h_sub[:, :, None], 2)[:, :, 0]
        bank_mid = (ru3 > t).any(axis=2)
        if score_fn is not None:
            score = np.asarray(score_fn(
                t, has_req=has_req, head_row=h_row, head_arrive=h_arr,
                head_is_write=h_w, bank_free=bank_free,
                head_ref_until=head_ru, bank_mid_ref=bank_mid,
                open_row=head_or, drain=drain, rank_drain=rank_drain_b))
        else:
            score = arbiter_scores_masked(
                t, has_req=has_req, idle=idle, head_ready=head_ru <= t,
                bank_mid_ref=bank_mid, head_row=h_row, head_arrive=h_arr,
                head_is_write=h_w, open_row=head_or, drain=drain,
                rank_drain=rank_drain_b, rank_can_drain=has_drain_block)
        for ch in range(NC):
            sc_ch = score[:, ch * RBC:(ch + 1) * RBC]
            bs_loc = sc_ch.argmax(axis=1)
            ok = sc_ch[arG, bs_loc] >= 0
            if not ok.any():
                continue
            gs = np.nonzero(ok)[0]
            bs = bs_loc[gs] + ch * RBC
            row, sub = h_row[gs, bs], h_sub[gs, bs]
            arr, isw = h_arr[gs, bs], h_w[gs, bs]
            hit = row == head_or[gs, bs]
            lat = np.where(hit, grid.HIT[gs], grid.MISS[gs])
            lat = lat + np.where(grid.sarp[gs] & bank_mid[gs, bs],
                                 grid.SARP_PEN[gs], 0)
            lat = lat + np.where(isw != last_op[gs, ch], grid.TURN[gs], 0)
            gr_b = bs // NB
            lr = last_rank[gs, ch]
            lat = lat + np.where((lr >= 0) & (lr != gr_b), grid.RTR[gs], 0)
            done = t + lat
            bank_free[gs, bs] = done + np.where(isw, grid.WR[gs], 0)
            last_op[gs, ch] = isw
            last_rank[gs, ch] = gr_b
            open_row_s[gs, bs * S + sub] = row
            open_sub[gs, bs] = sub
            n_served[gs, bs] += 1
            hits[gs] += hit
            misses[gs] += ~hit
            writes[gs] += isw
            reads[gs] += ~isw
            wpend[gs] -= isw
            drain[gs] &= ~(isw & (wpend[gs] <= LO))
            rmask = ~isw
            lrec = np.minimum(done - arr, MAX_LAT_TICKS)
            lat_sum[gs] += np.where(rmask, lrec, 0)
            np.add.at(hist, (gs[rmask], lrec[rmask]), 1)
            last_done[gs] = np.maximum(last_done[gs], done)
            # refresh the head-of-queue mirror for the served banks
            gf = gs * B + bs
            sl = np.minimum(n_served[gs, bs], L - 1)
            h_arr[gs, bs] = qa[gf, sl]
            h_row[gs, bs] = qr[gf, sl]
            h_sub[gs, bs] = qs[gf, sl]
            h_w[gs, bs] = qw[gf, sl]
            # ---- E: retire finished cells
            n_left[gs] -= 1
            if (n_left[gs] == 0).any():
                done_cells = gs[n_left[gs] == 0]
                active[done_cells] = False
                kind_active[done_cells] = KIND_IDEAL
                alive = int(active.sum())
        t += 1

    finished = ~active
    return _finalize_cells(grid, reads=reads, writes=writes, hits=hits,
                           misses=misses, refpb=refpb, refab=refab,
                           lat_sum=lat_sum, hist=hist, maxlag=maxlag,
                           last_done=last_done, finished=finished)


# ------------------------------------------------ batched backend (closed)
def _run_batched_closed(grid: _Grid, arbiter: str = "numpy", *,
                        record_commands: bool = False, device=None):
    """Closed-loop mode over the stacked state: the open-loop machine plus
    vectorized per-core MLP windows, write-buffer backpressure, and ring
    bank queues fed by the cores (contract in the module docstring).

    Returns the cell list; with `record_commands=True` returns
    `(cells, traces)` where `traces[g]` is the cell's DFI-style
    `repro_torch.core.commands.CmdTrace` — emitted at the same three hook
    points as `DramSim.run_ticks` (refresh decisions and serves), so the
    per-cell trace is command-identical to the reference engine's. The
    per-command Python appends only run when recording; the vectorized
    loop is untouched otherwise."""
    spec = grid.spec
    G, B, S = grid.G, grid.B, grid.S
    NB, R, NC = grid.NB, grid.R, grid.NC
    RBC = grid.NR * NB               # banks per channel
    C, N, K = grid.C, grid.N, grid.K
    LQ = grid.LQ
    QM = LQ - 1
    HI, LO, CAP = spec.wbuf_hi, spec.wbuf_lo, spec.wbuf_cap

    recs = None
    if record_commands:
        from repro_torch.core.commands.trace import CmdRecorder, tick_meta
        recs = []
        for (p, s, d) in grid.cells:
            recs.append(CmdRecorder(tick_meta(
                grid.dram[d], resolve_policy(p), spec.dt_ns,
                scenario=_scenario_name(s),
                wbuf=(spec.wbuf_cap, spec.wbuf_hi, spec.wbuf_lo))))

    score_fn = None
    if arbiter == "cuda":
        from repro_torch.kernels.sweep_arbiter import make_arbiter
        score_fn = make_arbiter(G, B, device)
    elif arbiter != "numpy":
        raise ValueError(f"unknown arbiter {arbiter!r}")

    # each cell's streams as flat [G*C, N] planes for single-op gathers
    sw, sb, sr, ssub, sth = grid.cell_streams().values()
    n_req = grid.n_req_c
    mlp_col = grid.mlp_g[:, None]

    # ring bank queues, flat [G*B, LQ]
    qa = np.zeros((G * B, LQ), np.int32)
    qr = np.zeros((G * B, LQ), np.int32)
    qs = np.zeros((G * B, LQ), np.int32)
    qw = np.zeros((G * B, LQ), bool)
    qc = np.zeros((G * B, LQ), np.int32)
    q_head = np.zeros((G, B), np.int32)
    q_tail = np.zeros((G, B), np.int32)

    # core state
    next_idx = np.zeros((G, C), np.int32)
    next_issue = np.zeros((G, C), np.int32)
    out_reads = np.zeros((G, C), np.int32)
    remaining = n_req.astype(np.int32).copy()
    finish = np.where(remaining == 0, 0, -1).astype(np.int32)
    comp_t = np.full((G, C, K), _PAD_ARRIVE, np.int32)

    # machine state, stacked [G, B]; refresh occupancy and open rows are
    # subarray-granular, [G, B * S] with column gs = bank * S + sub
    bank_free = np.zeros((G, B), np.int32)
    ref_until_s = np.zeros((G, B * S), np.int32)
    open_row_s = np.full((G, B * S), -1, np.int32)
    open_sub = np.full((G, B), -1, np.int32)
    ctr = np.zeros((G, B), np.int32)
    issued = np.zeros((G, B), np.int32)
    rr = np.zeros(G, np.int32)
    ab_rr = np.zeros(G, np.int32)          # staggered_ab rank pointer
    wpend = np.zeros(G, np.int32)
    drain = np.zeros(G, bool)
    last_op = np.zeros((G, NC), bool)      # per-channel bus turnaround
    last_rank = np.full((G, NC), -1, np.int32)
    ab_pending = np.zeros((G, R), np.int32)
    rank_drain = np.zeros((G, R), bool)
    active = (remaining > 0).any(axis=1)
    kind_active = np.where(active, grid.kind, KIND_IDEAL)
    has_ab = bool(grid.level_ab.any())

    # stats
    reads = np.zeros(G, np.int64)
    writes = np.zeros(G, np.int64)
    hits = np.zeros(G, np.int64)
    misses = np.zeros(G, np.int64)
    refpb = np.zeros(G, np.int64)
    refab = np.zeros(G, np.int64)
    lat_sum = np.zeros(G, np.int64)
    hist = np.zeros((G, MAX_LAT_TICKS + 1), np.int32)
    maxlag = np.zeros(G, np.int32)
    last_done = np.zeros(G, np.int32)

    phase, REFI_col = grid.phase, grid.REFI[:, None]
    RFC_PB_col = grid.RFC_PB[:, None]
    sarp_c = grid.sarp[:, None]
    hra_c = grid.hra[:, None]
    sub_of_col = np.tile(np.arange(S, dtype=np.int32), B)[None, :]
    kind_g = grid.kind
    budget_g, wrp_g, urgent_g = grid.budget, grid.wrp, grid.urgent_at
    level_ab = grid.level_ab
    rank_phase_g = grid.rank_phase          # [G, R] accrual stagger
    #: ticks where SOME ab cell's rank accrues debt: (REFI, phase) pairs
    accrual_keys = sorted({(int(grid.REFI[g]), int(p))
                           for g in np.nonzero(level_ab)[0]
                           for p in grid.rank_phase[g]})
    has_drain_block = has_ab or bool(grid.customs)
    arG = np.arange(G, dtype=np.int64)   # fancy-index helpers, not planes
    arB = np.arange(B, dtype=np.int64)
    flat_gc = arG[:, None] * C + np.arange(C, dtype=np.int64)[None, :]
    flat_gb = arG[:, None] * B + arB[None, :]
    t = 0
    alive = int(active.sum())
    while alive and t < grid.horizon:
        # ---- 0: outstanding-read completions
        exp = comp_t <= t
        if exp.any():
            n_exp = exp.sum(axis=2).astype(np.int32)
            out_reads -= n_exp
            remaining -= n_exp
            comp_t[exp] = _PAD_ARRIVE

        # ---- 1: core issue (at most one per core per tick, core order)
        sl = np.minimum(next_idx, N - 1)
        can = (next_idx < n_req) & (next_issue <= t)
        if can.any():
            head_w = sw[flat_gc, sl]
            want_w = can & head_w
            want_r = can & ~head_w & (out_reads < mlp_col)
            # write-buffer backpressure, first-come in core order
            rank_w = np.cumsum(want_w, axis=1) - want_w
            ok_w = want_w & (rank_w < (CAP - wpend)[:, None])
            issue = ok_w | want_r
            if issue.any():
                hb = sb[flat_gc, sl]
                oh = issue[:, :, None] & (hb[:, :, None] == arB[None, None, :])
                pref = np.cumsum(oh, axis=1) - oh
                gi, ci = np.nonzero(issue)
                bk = hb[gi, ci]
                slot = (q_tail[gi, bk] + pref[gi, ci, bk]) & QM
                gf = gi * B + bk
                fgc = gi * C + ci
                idx2 = sl[gi, ci]
                qa[gf, slot] = t
                qr[gf, slot] = sr[fgc, idx2]
                qs[gf, slot] = ssub[fgc, idx2]
                qw[gf, slot] = sw[fgc, idx2]
                qc[gf, slot] = ci
                q_tail += oh.sum(axis=1).astype(np.int32)
                wpend += ok_w.sum(axis=1).astype(np.int32)
                out_reads += want_r
                remaining -= ok_w                 # writes retire at issue
                next_issue[issue] = t + sth[fgc, idx2]
                next_idx[issue] += 1

        newly = (remaining == 0) & (finish < 0)
        if newly.any():
            finish[newly] = t
            done_cells = active & ~(remaining > 0).any(axis=1)
            if done_cells.any():
                active &= ~done_cells
                kind_active[done_cells] = KIND_IDEAL
                alive = int(active.sum())
                if not alive:
                    break

        # ---- 2: write-drain watermark
        drain |= wpend >= HI

        # ---- 3: per-rank refresh debt for all-bank policies (rank r
        # accrues r * tREFI/R after rank 0 — cross-rank staggering)
        if has_ab and any(t > p and (t - p) % rv == 0
                          for rv, p in accrual_keys):
            acc = ((active & level_ab)[:, None]
                   & (t > rank_phase_g)
                   & ((t - rank_phase_g) % REFI_col == 0))
            ab_pending += acc
            rank_drain |= acc

        # ---- 4: policy decisions against the stacked view
        due = np.maximum((t - phase) // REFI_col + 1, 0)
        lag = due - issued
        demand = q_tail - q_head
        ready = (ref_until_s.reshape(G, B, S) <= t).all(axis=2)
        idle = bank_free <= t
        need = could_pick(kind=kind_active, lag=lag, demand=demand,
                          write_window=drain, budget=budget_g, wrp=wrp_g)
        picks = None
        if need.any():
            picks, rr = select_batch(
                np, kind=np.where(need, kind_active, KIND_IDEAL), lag=lag,
                ready=ready, idle=idle, demand=demand, write_window=drain,
                budget=budget_g, wrp=wrp_g, urgent_at=urgent_g, rr=rr,
                gate=True, nb=NB)
            if not picks.any():
                picks = None

        start_ab_r = None
        if has_ab:
            quiet_r = (idle.reshape(G, R, NB).all(axis=2)
                       & ready.reshape(G, R, NB).all(axis=2))
            pend = (active & (kind_g == KIND_AB))[:, None] & (ab_pending > 0)
            if pend.any():
                start_ab_r = pend & quiet_r
            if grid.has_stag:       # staggered_ab: rank round-robin
                is_st = active & (kind_g == KIND_STAG)
                idx = ab_rr % R
                chan_ready = ready.reshape(G, NC, RBC).all(axis=2)
                elig = (is_st & (ab_pending[arG, idx] > 0)
                        & quiet_r[arG, idx]
                        & chan_ready[arG, idx // grid.NR])
                if elig.any():
                    if start_ab_r is None:
                        start_ab_r = np.zeros((G, R), bool)
                    start_ab_r[arG[elig], idx[elig]] = True
                ab_rr = ab_rr + elig

        for g, pol in grid.customs:          # non-vectorizable registrations
            if not active[g]:
                continue
            if pol.level == "ab":
                if ab_pending[g].sum() <= 0:
                    continue
                quiet_g = bool(idle[g].all() and ready[g].all())
                view = MaintenanceView(
                    now=float(t), n_banks=B, budget=int(grid.budget[g]),
                    lag=[0] * B, demand=[0] * B,
                    ready=ready[g].tolist(), idle=idle[g].tolist(),
                    write_window=bool(drain[g]),
                    max_issues=1, rank_due=int(ab_pending[g].sum()),
                    rank_quiet=quiet_g,
                    n_ranks=grid.NR, n_channels=NC,
                    rank_of=grid.rank_of_t, channel_of=grid.chan_of_t,
                    ranks_due=tuple(int(x) for x in ab_pending[g]),
                    n_subarrays=S,
                    next_ref_sub=tuple(int(x) % S for x in ctr[g]),
                    refreshing_sub=_refreshing_subs(
                        ref_until_s[g].reshape(B, S), t),
                    active_sub=tuple(int(x) for x in open_sub[g]))
                for dec in pol.select(view):
                    if dec.bank == ALL_BANKS:
                        if start_ab_r is None:
                            start_ab_r = np.zeros((G, R), bool)
                        if dec.rank >= 0:
                            # debt-free ranks skipped (no negative debt)
                            if ab_pending[g, dec.rank] > 0:
                                start_ab_r[g, dec.rank] = True
                        else:
                            start_ab_r[g] |= ab_pending[g] > 0
            else:
                view = MaintenanceView(
                    now=float(t), n_banks=B, budget=int(grid.budget[g]),
                    lag=lag[g].tolist(), demand=demand[g].tolist(),
                    ready=ready[g].tolist(), idle=idle[g].tolist(),
                    write_window=bool(drain[g]), max_issues=1,
                    n_ranks=grid.NR, n_channels=NC,
                    rank_of=grid.rank_of_t, channel_of=grid.chan_of_t,
                    n_subarrays=S,
                    next_ref_sub=tuple(int(x) % S for x in ctr[g]),
                    refreshing_sub=_refreshing_subs(
                        ref_until_s[g].reshape(B, S), t),
                    active_sub=tuple(int(x) for x in open_sub[g]))
                for dec in pol.select(view):
                    if dec.bank == ALL_BANKS:
                        raise ValueError(
                            f"policy {pol.name!r} returned ALL_BANKS from "
                            f"a per-bank (level='pb') decision point")
                    if picks is None:
                        picks = np.zeros((G, B), bool)
                    picks[g, dec.bank] = True

        if start_ab_r is not None and start_ab_r.any():
            m = np.repeat(start_ab_r, NB, axis=1)
            new_sub = (ctr % S).astype(np.int32)
            # SARP marks (and closes) only the target subarray ctr % S;
            # a non-SARP refresh occupies every subarray of the bank
            mark = (np.repeat(m, S, axis=1)
                    & np.where(sarp_c, np.repeat(new_sub, S, axis=1)
                               == sub_of_col, True))
            ref_until_s = np.where(mark, (t + grid.RFC_AB)[:, None],
                                   ref_until_s)
            open_row_s = np.where(mark, -1, open_row_s)
            ctr = ctr + (m & sarp_c)
            ab_pending -= start_ab_r
            rank_drain = np.where(start_ab_r, ab_pending > 0, rank_drain)
            refab += start_ab_r.sum(axis=1)
            if recs is not None:
                for g_, r_ in zip(*np.nonzero(start_ab_r)):
                    recs[g_].emit_rank(t, "PREA", int(r_))
                    recs[g_].emit_rank(t + int(grid.TRP[g_]), "REF_AB",
                                       int(r_), data=t)

        if picks is not None:
            new_sub = (ctr % S).astype(np.int32)
            # HiRA hidden row activation: when the refresh targets a
            # subarray the in-flight access is NOT using, start it at t —
            # overlapping the access — instead of waiting for the bank
            # (inert at S=1: the lone subarray matches open_sub once any
            # access has been served, and bank_free <= t before then)
            start = np.maximum(t, bank_free)
            start = np.where(hra_c & (new_sub != open_sub), t, start)
            if recs is not None:
                for g_, b_ in zip(*np.nonzero(picks)):
                    st = int(start[g_, b_])
                    tsub = int(new_sub[g_, b_]) if grid.sarp[g_] else -1
                    recs[g_].emit(st, "PRE", int(b_), sub=tsub)
                    recs[g_].emit(st + int(grid.TRP[g_]), "REF_PB",
                                  int(b_), sub=tsub, data=t)
            mark = (np.repeat(picks, S, axis=1)
                    & np.where(sarp_c, np.repeat(new_sub, S, axis=1)
                               == sub_of_col, True))
            ref_until_s = np.where(
                mark, np.repeat(start + RFC_PB_col, S, axis=1), ref_until_s)
            open_row_s = np.where(mark, -1, open_row_s)
            ctr = ctr + picks
            issued = issued + picks
            refpb += picks.sum(axis=1)
            lag_after = due - issued
            maxlag = np.maximum(
                maxlag, np.where(picks, np.abs(lag_after), 0).max(axis=1))

        # ---- 5: occupancy-aware arbitration — one start per channel
        # (scores — incl. the drain flag — snapshotted before any serve)
        has_req = (demand > 0) & active[:, None]
        if not has_req.any():
            t += 1
            continue
        hslot = q_head & QM
        h_arr = qa[flat_gb, hslot]
        h_row = qr[flat_gb, hslot]
        h_sub = qs[flat_gb, hslot]
        h_w = qw[flat_gb, hslot]
        rank_drain_b = np.repeat(rank_drain, NB, axis=1)
        ru3 = ref_until_s.reshape(G, B, S)
        head_ru = np.take_along_axis(ru3, h_sub[:, :, None], 2)[:, :, 0]
        head_or = np.take_along_axis(
            open_row_s.reshape(G, B, S), h_sub[:, :, None], 2)[:, :, 0]
        bank_mid = (ru3 > t).any(axis=2)
        if score_fn is not None:
            score = np.asarray(score_fn(
                t, has_req=has_req, head_row=h_row, head_arrive=h_arr,
                head_is_write=h_w, bank_free=bank_free,
                head_ref_until=head_ru, bank_mid_ref=bank_mid,
                open_row=head_or, drain=drain, rank_drain=rank_drain_b,
                occ=demand))
        else:
            score = arbiter_scores_masked(
                t, has_req=has_req, idle=idle, head_ready=head_ru <= t,
                bank_mid_ref=bank_mid, head_row=h_row, head_arrive=h_arr,
                head_is_write=h_w, open_row=head_or, drain=drain,
                rank_drain=rank_drain_b, rank_can_drain=has_drain_block,
                occ=demand)
        for ch in range(NC):
            sc_ch = score[:, ch * RBC:(ch + 1) * RBC]
            bs_loc = sc_ch.argmax(axis=1)
            ok = sc_ch[arG, bs_loc] >= 0
            if not ok.any():
                continue
            gs = np.nonzero(ok)[0]
            bs = bs_loc[gs] + ch * RBC
            row, sub = h_row[gs, bs], h_sub[gs, bs]
            arr, isw = h_arr[gs, bs], h_w[gs, bs]
            core = qc[gs * B + bs, hslot[gs, bs]]
            hit = row == head_or[gs, bs]
            lat = np.where(hit, grid.HIT[gs], grid.MISS[gs])
            lat = lat + np.where(grid.sarp[gs] & bank_mid[gs, bs],
                                 grid.SARP_PEN[gs], 0)
            lat = lat + np.where(isw != last_op[gs, ch], grid.TURN[gs], 0)
            gr_b = bs // NB
            lr = last_rank[gs, ch]
            lat = lat + np.where((lr >= 0) & (lr != gr_b), grid.RTR[gs], 0)
            done = t + lat
            if recs is not None:
                oldr = head_or[gs, bs]
                for k in range(len(gs)):
                    g_, b_ = int(gs[k]), int(bs[k])
                    sb_, rw_ = int(sub[k]), int(row[k])
                    if not hit[k]:
                        if oldr[k] != -1:
                            recs[g_].emit(t, "PRE", b_, sub=sb_)
                        recs[g_].emit(t, "ACT", b_, sub=sb_, row=rw_)
                    recs[g_].emit(t, "WR" if isw[k] else "RD", b_,
                                  sub=sb_, row=rw_, data=int(done[k]))
            bank_free[gs, bs] = done + np.where(isw, grid.WR[gs], 0)
            last_op[gs, ch] = isw
            last_rank[gs, ch] = gr_b
            open_row_s[gs, bs * S + sub] = row
            open_sub[gs, bs] = sub
            q_head[gs, bs] += 1
            hits[gs] += hit
            misses[gs] += ~hit
            writes[gs] += isw
            reads[gs] += ~isw
            wpend[gs] -= isw
            drain[gs] &= ~(isw & (wpend[gs] <= LO))
            rmask = ~isw
            lrec = np.minimum(done - arr, MAX_LAT_TICKS)
            lat_sum[gs] += np.where(rmask, lrec, 0)
            np.add.at(hist, (gs[rmask], lrec[rmask]), 1)
            last_done[gs] = np.maximum(last_done[gs], done)
            # reads: park the data return in the core's MLP window slot
            if rmask.any():
                gr, cr = gs[rmask], core[rmask]
                k = np.argmax(comp_t[gr, cr] == _PAD_ARRIVE, axis=1)
                comp_t[gr, cr, k] = done[rmask]
        t += 1

    finished = ~active
    fin = np.where(finish < 0, t, finish)
    cells = _finalize_cells(grid, reads=reads, writes=writes, hits=hits,
                            misses=misses, refpb=refpb, refab=refab,
                            lat_sum=lat_sum, hist=hist, maxlag=maxlag,
                            last_done=last_done, finished=finished,
                            core_finish=fin)
    if recs is not None:
        traces = [recs[g].trace(end=int(fin[g].max()))
                  for g in range(grid.G)]
        return cells, traces
    return cells


# ---------------------------------------------------------- scalar oracle
def _run_scalar_cell(grid: _Grid, g: int) -> CellResult:
    """Plain-Python reference: one cell, real policy object, same tick
    contract. Deliberately shares no machine code with the batched path."""
    spec = grid.spec
    p, s, d = grid.cells[g]
    tk = grid.timing[d]
    B, S = grid.B, grid.S
    NB, R, NC = grid.NB, grid.R, grid.NC
    RBC = grid.NR * NB               # banks per channel
    HI, LO = spec.wbuf_hi, spec.wbuf_lo
    pol = resolve_policy(p)
    hra = bool(getattr(pol, "hra", False))
    budget = tk.budget

    i = grid.scn_of_cell[g]
    q = []
    for b in range(B):
        n = int(grid.scn_npb[i, b])
        q.append(list(zip(grid.scn_qa[i, b, :n].tolist(),
                          grid.scn_qr[i, b, :n].tolist(),
                          grid.scn_qs[i, b, :n].tolist(),
                          grid.scn_qw[i, b, :n].tolist())))
    total = sum(len(x) for x in q)
    phase = [b * tk.REFI_PB for b in range(B)]
    rank_phase = [gr * (tk.REFI // R) for gr in range(R)]

    bank_free = [0] * B
    ref_until_s = [[0] * S for _ in range(B)]
    open_row_s = [[-1] * S for _ in range(B)]
    open_sub = [-1] * B
    ctr = [0] * B
    issued = [0] * B
    n_arrived = [0] * B
    n_served = [0] * B
    wpend = 0
    drain = False
    last_op = [False] * NC
    last_rank = [-1] * NC
    ab_pending = [0] * R
    rank_drain = [False] * R
    served = 0

    reads = writes = hits = misses = refpb = refab = 0
    lat_sum = 0
    hist = np.zeros(MAX_LAT_TICKS + 1, np.int32)
    maxlag = 0
    last_done = 0

    def due(b: int, t: int) -> int:
        return 0 if t < phase[b] else (t - phase[b]) // tk.REFI + 1

    def start_pb(b: int, t: int):
        nonlocal refpb, maxlag
        ns = ctr[b] % S
        # HiRA: hide the refresh activation behind an in-flight access to
        # a different subarray (start at t instead of waiting for the bank)
        start = t if (hra and ns != open_sub[b]) else max(t, bank_free[b])
        end = start + tk.RFC_PB
        if pol.sarp:
            ref_until_s[b][ns] = end
            open_row_s[b][ns] = -1
        else:
            for s_ in range(S):
                ref_until_s[b][s_] = end
                open_row_s[b][s_] = -1
        ctr[b] += 1
        issued[b] += 1
        refpb += 1
        maxlag = max(maxlag, abs(due(b, t) - issued[b]))

    def start_ab(gr: int, t: int):
        nonlocal refab
        end = t + tk.RFC_AB
        for b in range(gr * NB, (gr + 1) * NB):
            if pol.sarp:
                ns = ctr[b] % S
                ref_until_s[b][ns] = end
                open_row_s[b][ns] = -1
                ctr[b] += 1
            else:
                for s_ in range(S):
                    ref_until_s[b][s_] = end
                    open_row_s[b][s_] = -1
        ab_pending[gr] -= 1
        rank_drain[gr] = ab_pending[gr] > 0
        refab += 1

    def apply_ab_decisions(decs, t: int):
        for dec in decs:
            if dec.bank == ALL_BANKS:
                if dec.rank >= 0:
                    # debt-free ranks skipped: a buggy policy must not
                    # drive ab_pending negative
                    if ab_pending[dec.rank] > 0:
                        start_ab(dec.rank, t)
                else:
                    for gr in range(R):
                        if ab_pending[gr] > 0:
                            start_ab(gr, t)

    def ab_view(t: int) -> MaintenanceView:
        return MaintenanceView(
            now=float(t), n_banks=B, budget=budget,
            lag=[0] * B, demand=[0] * B,
            ready=[all(ru <= t for ru in ref_until_s[b])
                   for b in range(B)],
            idle=[bank_free[b] <= t for b in range(B)],
            write_window=drain, max_issues=1,
            rank_due=sum(ab_pending),
            rank_quiet=(all(f <= t for f in bank_free)
                        and all(ru <= t for rb in ref_until_s
                                for ru in rb)),
            n_ranks=grid.NR, n_channels=NC,
            rank_of=grid.rank_of_t, channel_of=grid.chan_of_t,
            ranks_due=tuple(ab_pending),
            n_subarrays=S,
            next_ref_sub=tuple(ctr[b] % S for b in range(B)),
            refreshing_sub=tuple(_scalar_refreshing_sub(ref_until_s[b], t)
                                 for b in range(B)),
            active_sub=tuple(open_sub))

    t = 0
    while served < total and t < grid.horizon:
        # A: arrivals
        for b in range(B):
            qb, nb = q[b], n_arrived[b]
            while nb < len(qb) and qb[nb][0] <= t:
                if qb[nb][3]:
                    wpend += 1
                nb += 1
            n_arrived[b] = nb
        if wpend >= HI:
            drain = True
        # B: per-rank refresh debt (staggered tREFI/R apart)
        if not pol.ideal and pol.level == "ab":
            for gr in range(R):
                if (t > rank_phase[gr]
                        and (t - rank_phase[gr]) % tk.REFI == 0):
                    ab_pending[gr] += 1
                    rank_drain[gr] = True
        # C: decision
        if not pol.ideal:
            if pol.level == "ab":
                if sum(ab_pending) > 0:
                    apply_ab_decisions(pol.select(ab_view(t)), t)
            else:
                view = MaintenanceView(
                    now=float(t), n_banks=B, budget=budget,
                    lag=[due(b, t) - issued[b] for b in range(B)],
                    demand=[n_arrived[b] - n_served[b] for b in range(B)],
                    ready=[all(ru <= t for ru in ref_until_s[b])
                           for b in range(B)],
                    idle=[bank_free[b] <= t for b in range(B)],
                    write_window=drain, max_issues=1,
                    n_ranks=grid.NR, n_channels=NC,
                    rank_of=grid.rank_of_t, channel_of=grid.chan_of_t,
                    n_subarrays=S,
                    next_ref_sub=tuple(ctr[b] % S for b in range(B)),
                    refreshing_sub=tuple(
                        _scalar_refreshing_sub(ref_until_s[b], t)
                        for b in range(B)),
                    active_sub=tuple(open_sub))
                for dec in pol.select(view):
                    if dec.bank == ALL_BANKS:
                        raise ValueError(
                            f"policy {pol.name!r} returned ALL_BANKS from "
                            f"a per-bank (level='pb') decision point")
                    start_pb(dec.bank, t)
        # D: arbitration (one start per channel; drain snapshotted)
        drain_arb = drain
        for ch in range(NC):
            best, best_score = -1, -1
            for b in range(ch * RBC, (ch + 1) * RBC):
                if n_arrived[b] - n_served[b] <= 0:
                    continue
                if rank_drain[b // NB]:
                    continue
                arr, row, sub, isw = q[b][n_served[b]]
                if bank_free[b] > t:
                    continue
                if ref_until_s[b][sub] > t:
                    continue
                sc = (W_WRITE if (drain_arb and isw) else 0) \
                    + (W_HIT if row == open_row_s[b][sub] else 0) \
                    + (0 if any(ru > t for ru in ref_until_s[b])
                       else W_NOCONF) \
                    + min(t - arr, AGE_CAP)
                if sc > best_score:
                    best, best_score = b, sc
            if best >= 0:
                b = best
                gr = b // NB
                arr, row, sub, isw = q[b][n_served[b]]
                hit = row == open_row_s[b][sub]
                lat = tk.HIT if hit else tk.MISS
                if pol.sarp and any(ru > t for ru in ref_until_s[b]):
                    lat += tk.SARP_PEN
                if isw != last_op[ch]:
                    lat += tk.TURN
                if 0 <= last_rank[ch] != gr:
                    lat += tk.RTR
                done = t + lat
                bank_free[b] = done + (tk.WR if isw else 0)
                last_op[ch] = isw
                last_rank[ch] = gr
                open_row_s[b][sub] = row
                open_sub[b] = sub
                n_served[b] += 1
                served += 1
                if hit:
                    hits += 1
                else:
                    misses += 1
                if isw:
                    writes += 1
                    wpend -= 1
                    if drain and wpend <= LO:
                        drain = False
                else:
                    reads += 1
                    lat_sum += min(done - arr, MAX_LAT_TICKS)
                    hist[min(done - arr, MAX_LAT_TICKS)] += 1
                last_done = max(last_done, done)
        t += 1

    return _finalize(grid, g, reads=reads, writes=writes, hits=hits,
                     misses=misses, refpb=refpb, refab=refab,
                     lat_sum=lat_sum, hist=hist, maxlag=maxlag,
                     last_done=last_done, finished=served >= total)


# ------------------------------------------------- scalar oracle (closed)
def _run_scalar_cell_closed(grid: _Grid, g: int) -> CellResult:
    """Plain-Python closed-loop reference: one cell, real policy object,
    MLP-limited cores on the closed tick contract (module docstring)."""
    spec = grid.spec
    p, s, d = grid.cells[g]
    tk = grid.timing[d]
    B, S = grid.B, grid.S
    NB, R, NC = grid.NB, grid.R, grid.NC
    RBC = grid.NR * NB               # banks per channel
    HI, LO, CAP = spec.wbuf_hi, spec.wbuf_lo, spec.wbuf_cap
    pol = resolve_policy(p)
    hra = bool(getattr(pol, "hra", False))
    budget = tk.budget
    dem = grid.demands[_scenario_name(s)]
    C, mlp = dem.n_cores, dem.mlp
    i = grid.scn_of_cell[g]
    sw = grid.scn_write[i]
    sb, sr = grid.scn_bank[i], grid.scn_row[i]
    ss, sth = grid.scn_sub[i], grid.scn_think[i]
    n_req = grid.scn_nreq[i].tolist()
    phase = [b * tk.REFI_PB for b in range(B)]
    rank_phase = [gr * (tk.REFI // R) for gr in range(R)]

    # per-bank FIFO of (issue_tick, row, sub, is_write, core)
    q: list[list[tuple]] = [[] for _ in range(B)]
    next_idx = [0] * C
    next_issue = [0] * C
    out_reads = [0] * C
    remaining = list(n_req)
    finish = [0 if remaining[c] == 0 else -1 for c in range(C)]
    n_finished = sum(1 for c in range(C) if remaining[c] == 0)
    comp: list[tuple[int, int]] = []      # (done_tick, core)

    bank_free = [0] * B
    ref_until_s = [[0] * S for _ in range(B)]
    open_row_s = [[-1] * S for _ in range(B)]
    open_sub = [-1] * B
    ctr = [0] * B
    issued = [0] * B
    wpend = 0
    drain = False
    last_op = [False] * NC
    last_rank = [-1] * NC
    ab_pending = [0] * R
    rank_drain = [False] * R

    reads = writes = hits = misses = refpb = refab = 0
    lat_sum = 0
    hist = np.zeros(MAX_LAT_TICKS + 1, np.int32)
    maxlag = 0
    last_done = 0

    def due(b: int, t: int) -> int:
        return 0 if t < phase[b] else (t - phase[b]) // tk.REFI + 1

    def start_pb(b: int, t: int):
        nonlocal refpb, maxlag
        ns = ctr[b] % S
        # HiRA: hide the refresh activation behind an in-flight access to
        # a different subarray (start at t instead of waiting for the bank)
        start = t if (hra and ns != open_sub[b]) else max(t, bank_free[b])
        end = start + tk.RFC_PB
        if pol.sarp:
            ref_until_s[b][ns] = end
            open_row_s[b][ns] = -1
        else:
            for s_ in range(S):
                ref_until_s[b][s_] = end
                open_row_s[b][s_] = -1
        ctr[b] += 1
        issued[b] += 1
        refpb += 1
        maxlag = max(maxlag, abs(due(b, t) - issued[b]))

    def start_ab(gr: int, t: int):
        nonlocal refab
        end = t + tk.RFC_AB
        for b in range(gr * NB, (gr + 1) * NB):
            if pol.sarp:
                ns = ctr[b] % S
                ref_until_s[b][ns] = end
                open_row_s[b][ns] = -1
                ctr[b] += 1
            else:
                for s_ in range(S):
                    ref_until_s[b][s_] = end
                    open_row_s[b][s_] = -1
        ab_pending[gr] -= 1
        rank_drain[gr] = ab_pending[gr] > 0
        refab += 1

    def apply_ab_decisions(decs, t: int):
        for dec in decs:
            if dec.bank == ALL_BANKS:
                if dec.rank >= 0:
                    # debt-free ranks skipped: a buggy policy must not
                    # drive ab_pending negative
                    if ab_pending[dec.rank] > 0:
                        start_ab(dec.rank, t)
                else:
                    for gr in range(R):
                        if ab_pending[gr] > 0:
                            start_ab(gr, t)

    def ab_view(t: int) -> MaintenanceView:
        return MaintenanceView(
            now=float(t), n_banks=B, budget=budget,
            lag=[0] * B, demand=[0] * B,
            ready=[all(ru <= t for ru in ref_until_s[b])
                   for b in range(B)],
            idle=[bank_free[b] <= t for b in range(B)],
            write_window=drain, max_issues=1,
            rank_due=sum(ab_pending),
            rank_quiet=(all(f <= t for f in bank_free)
                        and all(ru <= t for rb in ref_until_s
                                for ru in rb)),
            n_ranks=grid.NR, n_channels=NC,
            rank_of=grid.rank_of_t, channel_of=grid.chan_of_t,
            ranks_due=tuple(ab_pending),
            n_subarrays=S,
            next_ref_sub=tuple(ctr[b] % S for b in range(B)),
            refreshing_sub=tuple(_scalar_refreshing_sub(ref_until_s[b], t)
                                 for b in range(B)),
            active_sub=tuple(open_sub))

    t = 0
    while n_finished < C and t < grid.horizon:
        # ---- 0: outstanding-read completions
        if comp:
            rest = []
            for done, c in comp:
                if done <= t:
                    out_reads[c] -= 1
                    remaining[c] -= 1
                    if remaining[c] == 0:
                        finish[c] = t
                        n_finished += 1
                else:
                    rest.append((done, c))
            comp = rest
        # ---- 1: core issue (at most one per core per tick, core order)
        for c in range(C):
            i = next_idx[c]
            if i >= n_req[c] or t < next_issue[c]:
                continue
            if sw[c, i]:
                if wpend >= CAP:
                    continue                      # buffer full: stall core
                q[sb[c, i]].append((t, int(sr[c, i]), int(ss[c, i]),
                                    True, c))
                wpend += 1
                remaining[c] -= 1                 # writes retire at issue
                if remaining[c] == 0:
                    finish[c] = t
                    n_finished += 1
            else:
                if out_reads[c] >= mlp:
                    continue                      # MLP window full
                q[sb[c, i]].append((t, int(sr[c, i]), int(ss[c, i]),
                                    False, c))
                out_reads[c] += 1
            next_idx[c] = i + 1
            next_issue[c] = t + int(sth[c, i])
        if n_finished >= C:
            break           # cell deactivates: no maintenance/arb this tick
        # ---- 2: write-drain watermark
        if wpend >= HI:
            drain = True
        # ---- 3: per-rank refresh debt (staggered tREFI/R apart)
        if not pol.ideal and pol.level == "ab":
            for gr in range(R):
                if (t > rank_phase[gr]
                        and (t - rank_phase[gr]) % tk.REFI == 0):
                    ab_pending[gr] += 1
                    rank_drain[gr] = True
        # ---- 4: policy decision
        if not pol.ideal:
            if pol.level == "ab":
                if sum(ab_pending) > 0:
                    apply_ab_decisions(pol.select(ab_view(t)), t)
            else:
                view = MaintenanceView(
                    now=float(t), n_banks=B, budget=budget,
                    lag=[due(b, t) - issued[b] for b in range(B)],
                    demand=[len(q[b]) for b in range(B)],
                    ready=[all(ru <= t for ru in ref_until_s[b])
                           for b in range(B)],
                    idle=[bank_free[b] <= t for b in range(B)],
                    write_window=drain, max_issues=1,
                    n_ranks=grid.NR, n_channels=NC,
                    rank_of=grid.rank_of_t, channel_of=grid.chan_of_t,
                    n_subarrays=S,
                    next_ref_sub=tuple(ctr[b] % S for b in range(B)),
                    refreshing_sub=tuple(
                        _scalar_refreshing_sub(ref_until_s[b], t)
                        for b in range(B)),
                    active_sub=tuple(open_sub))
                for dec in pol.select(view):
                    if dec.bank == ALL_BANKS:
                        raise ValueError(
                            f"policy {pol.name!r} returned ALL_BANKS from "
                            f"a per-bank (level='pb') decision point")
                    start_pb(dec.bank, t)
        # ---- 5: arbitration (occupancy-aware; one start per channel;
        # drain snapshotted before any serve this tick)
        drain_arb = drain
        for ch in range(NC):
            best, best_score = -1, -1
            for b in range(ch * RBC, (ch + 1) * RBC):
                if not q[b]:
                    continue
                if rank_drain[b // NB]:
                    continue
                arr, row, sub, isw, core = q[b][0]
                if bank_free[b] > t:
                    continue
                if ref_until_s[b][sub] > t:
                    continue
                sc = (W_WRITE if (drain_arb and isw) else 0) \
                    + W_OCC * min(len(q[b]), OCC_CAP) \
                    + (W_HIT if row == open_row_s[b][sub] else 0) \
                    + (0 if any(ru > t for ru in ref_until_s[b])
                       else W_NOCONF) \
                    + min(t - arr, AGE_CAP)
                if sc > best_score:
                    best, best_score = b, sc
            if best >= 0:
                b = best
                gr = b // NB
                arr, row, sub, isw, core = q[b].pop(0)
                hit = row == open_row_s[b][sub]
                lat = tk.HIT if hit else tk.MISS
                if pol.sarp and any(ru > t for ru in ref_until_s[b]):
                    lat += tk.SARP_PEN
                if isw != last_op[ch]:
                    lat += tk.TURN
                if 0 <= last_rank[ch] != gr:
                    lat += tk.RTR
                done = t + lat
                bank_free[b] = done + (tk.WR if isw else 0)
                last_op[ch] = isw
                last_rank[ch] = gr
                open_row_s[b][sub] = row
                open_sub[b] = sub
                if hit:
                    hits += 1
                else:
                    misses += 1
                if isw:
                    writes += 1
                    wpend -= 1
                    if drain and wpend <= LO:
                        drain = False
                else:
                    reads += 1
                    lat_sum += min(done - arr, MAX_LAT_TICKS)
                    hist[min(done - arr, MAX_LAT_TICKS)] += 1
                    comp.append((done, core))
                last_done = max(last_done, done)
        t += 1

    fin = [f if f >= 0 else t for f in finish]
    return _finalize(grid, g, reads=reads, writes=writes, hits=hits,
                     misses=misses, refpb=refpb, refab=refab,
                     lat_sum=lat_sum, hist=hist, maxlag=maxlag,
                     last_done=last_done, finished=n_finished >= C,
                     core_finish=fin)




# ------------------------------------------------------- torch tick body
def _check_traced_guards(grid: _Grid, backend: str = "torch") -> None:
    """Shared preconditions of the tensor backends (torch and mega)."""
    if grid.customs:
        raise ValueError(
            f"backend={backend!r} supports only the built-in policy "
            "classes; custom policies "
            f"{[p.name for _, p in grid.customs]!r} need "
            "backend='batched'")
    # state planes are int32: the clipped-latency sum fits only while
    # reads_per_cell * MAX_LAT_TICKS < 2**31
    if int(grid.n_tot.max()) * MAX_LAT_TICKS >= 2 ** 31:
        raise ValueError(
            f"backend={backend!r} accumulates latency sums in int32; "
            f"{int(grid.n_tot.max())} requests per cell could overflow — "
            "use backend='batched'")


def _resolve_device(device, backend: str):
    """`device=None` means the card. Asking for the card without one
    raises: no backend carries on on the CPU by itself."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"backend={backend!r} was asked to run on {str(dev)!r} but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path")
    return dev


def _run_torch_open(grid: _Grid, arbiter: str = "torch",
                    device=None) -> list[CellResult]:
    """Open-loop mode as a host-driven loop over the torch tick body
    (`sweep.torchbody`, the counterpart of the reference's jitted
    `lax.while_loop`): state lives in int32/bool tensors on `device`,
    one eager tick per iteration, bit-identical to numpy and the scalar
    oracle. `arbiter="cuda"` scores through the arbiter kernel in its
    open form (no occupancy plane)."""
    _check_traced_guards(grid)
    from repro_torch.core.sweep import torchbody
    from repro_torch.kernels.sweep_arbiter import arbiter_for

    dev = _resolve_device(device, "torch")
    scores = arbiter_for(arbiter)
    cfg = torchbody.open_cfg(grid)
    cst = torchbody.open_consts(grid, dev)
    out = torchbody.state_to_numpy(torchbody.run_open(cfg, cst, scores))
    finished = out["n_served"].sum(axis=1) >= grid.n_tot
    return _finalize_cells(grid, **_stat_columns(out), hist=out["hist"],
                           finished=finished)


def _run_torch_closed(grid: _Grid, arbiter: str = "torch",
                      device=None) -> list[CellResult]:
    """Closed-loop mode as a host-driven loop over the torch tick body
    (`sweep.torchbody`, the counterpart of the reference's jitted
    `lax.while_loop`): state lives in int32/bool tensors on `device`,
    one eager tick per iteration. Same all-integer contract,
    bit-identical to numpy and the scalar closed oracle. On the card
    every tick is a few hundred small launches — this is the plain
    version the megakernel is held against, not a fast path."""
    _check_traced_guards(grid)
    from repro_torch.core.sweep import torchbody
    from repro_torch.kernels.sweep_arbiter import arbiter_for

    dev = _resolve_device(device, "torch")
    scores = arbiter_for(arbiter)
    cfg = torchbody.closed_cfg(grid)
    cst = torchbody.closed_consts(grid, dev)
    out = torchbody.state_to_numpy(torchbody.run_closed(cfg, cst, scores))
    finished = (out["remaining"] <= 0).all(axis=1)
    t_end = int(out["t"])
    fin = np.where(out["finish"] < 0, t_end, out["finish"])
    return _finalize_cells(grid, **_stat_columns(out), hist=out["hist"],
                           finished=finished, core_finish=fin)


# ----------------------------------------------------- megakernel backend
def _run_mega(grid: _Grid, n_shards: int = 1, device=None,
              seconds: Optional[dict] = None) -> list[CellResult]:
    """The CUDA tick-loop megakernels
    (`repro_torch.kernels.sweep_megakernel`, one for each mode): every
    cell runs its whole tick loop on a group of lanes of one launch, reads
    its scenario's stream plane by index, exits alone, and ships home only
    its integer stat row (p99 reduced in the kernel — no [G, 4096]
    histogram round-trip).
    With CPU tensors the same host layout runs the plain version
    (`sweep.torchbody`) instead. Bit-identical to every other backend.
    `seconds`, when given, receives the wall seconds of the device run
    (``"run"``: pack, upload, launch, download) and of `_finalize_cells`:
    the durations of the spans ``sweep.run`` and ``sweep.finalize``."""
    _check_traced_guards(grid, backend="mega")
    from repro_torch.kernels.sweep_megakernel import run_mega

    with trace.timed("sweep.run") as run:
        out = run_mega(grid, n_shards=n_shards, device=device)
    with trace.timed("sweep.finalize") as fin:
        cells = _finalize_cells(grid, **_stat_columns(out),
                                finished=out["finished"], p99=out["p99"],
                                core_finish=out["core_finish"])
    if seconds is not None:
        seconds.update(run=run.seconds, finalize=fin.seconds)
    return cells


# ------------------------------------------------------------------ entry
def sweep(spec: SweepSpec, backend: str = "mega",
          arbiter: Optional[str] = None, *,
          record_commands: bool = False, n_shards: int = 1,
          device=None) -> SweepResult:
    """Run the whole grid.

    backend="mega"    : the CUDA tick-loop megakernels
                        (`repro_torch.kernels.sweep_megakernel`, one per
                        mode), the default; built-in policy classes only;
                        `n_shards` > 1 splits the cell axis across cards,
    backend="torch"   : a host-driven loop over the torch tick body
                        (`sweep.torchbody`), built-in policy classes only,
    backend="batched" : stacked-numpy lock-step on the host (supports
                        custom policy registrations via per-cell
                        fallback),
    backend="scalar"  : plain-Python per-cell reference oracle (host).

    `device` places the tensor backends: None means ``"cuda"`` — with no
    card, or a kernel that does not build or launch, the call raises;
    nothing falls back to the CPU. ``device="cpu"`` runs "torch" on CPU
    tensors and "mega" through the same host layout with the kernel's
    plain PyTorch version.

    `arbiter` selects the arbitration-scoring step: "numpy" (batched
    default), "torch" (torch default), or "cuda" (the kernel in
    `repro_torch.kernels.sweep_arbiter`, for "batched" and "torch").

    Every backend runs both `spec.mode` values; closed-loop cells
    additionally carry `core_finish`, making
    `CellResult.weighted_speedup_vs` (the paper's metric) available.

    `record_commands=True` (batched or mega backend, closed mode only)
    additionally emits
    a per-cell DFI-style command trace, retrievable via
    `SweepResult.commands_for(policy, scenario, density)` — the same
    `repro_torch.core.commands.CmdTrace` `DramSim.run_ticks` emits,
    command for command (tick-contract section 7). The megakernel does
    not emit in-kernel: it reruns the grid on the emitting batched
    backend and *reconciles* — every CellResult must match bit-for-bit,
    or the sweep raises.
    """
    with trace.span("sweep"):
        return _sweep(spec, backend, arbiter, record_commands=record_commands,
                      n_shards=n_shards, device=device)


def _sweep(spec: SweepSpec, backend: str, arbiter: Optional[str], *,
           record_commands: bool, n_shards: int, device) -> SweepResult:
    closed = spec.mode == "closed"
    if record_commands and not (backend in ("batched", "mega") and closed):
        raise ValueError(
            "record_commands=True needs backend='batched' or 'mega' and "
            "mode='closed' (the torch/scalar backends do not emit; use "
            "DramSim.run_ticks(record_commands=True) per cell instead)")
    if n_shards != 1 and backend != "mega":
        raise ValueError(
            f"n_shards is a megakernel knob; backend={backend!r} runs on "
            "one device (use backend='mega')")
    if backend == "mega":
        with trace.timed("sweep.grid") as g:
            grid = _Grid(spec)
        secs = {"grid": g.seconds}
        cells = _run_mega(grid, n_shards=n_shards, device=device,
                          seconds=secs)
        res = SweepResult(spec, cells, backend)
        res.seconds = secs
        if record_commands:
            ref = sweep(spec, backend="batched", record_commands=True)
            bad = [i for i, (a, b) in enumerate(zip(cells, ref.cells))
                   if a != b]
            if bad:
                raise RuntimeError(
                    "megakernel results fail to reconcile with the "
                    "command-emitting batched backend at cells "
                    f"{bad[:5]}{'...' if len(bad) > 5 else ''} of "
                    f"{len(cells)}")
            res.commands = ref.commands
        return res
    with trace.span("sweep.grid"):
        grid = _Grid(spec)
    traces = None
    if backend == "batched":
        arb = arbiter or "numpy"
        if arb == "cuda":
            device = _resolve_device(device, "batched")
        if not closed:
            cells = _run_batched(grid, arbiter=arb, device=device)
        elif record_commands:
            cells, traces = _run_batched_closed(
                grid, arbiter=arb, record_commands=True, device=device)
        else:
            cells = _run_batched_closed(grid, arbiter=arb, device=device)
    elif backend == "torch":
        run = _run_torch_closed if closed else _run_torch_open
        cells = run(grid, arbiter=arbiter or "torch", device=device)
    elif backend == "scalar":
        run_cell = _run_scalar_cell_closed if closed else _run_scalar_cell
        cells = [run_cell(grid, g) for g in range(grid.G)]
    else:
        raise ValueError(f"unknown sweep backend {backend!r}")
    res = SweepResult(spec, cells, backend)
    if traces is not None:
        res.commands = {(c.policy, c.scenario, c.density_gb): tr
                        for c, tr in zip(cells, traces)}
    return res
