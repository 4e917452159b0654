"""Discrete-event DRAM-subsystem simulator (the paper's evaluation vehicle).

Models a [channel, rank, bank] hierarchy: `DramTiming.n_channels` data
buses, `n_ranks` ranks per channel, N banks x M subarrays per rank —
per-channel buses with read/write AND rank-to-rank turnaround penalties,
FR-FCFS-style scheduling, a shared write buffer with high/low watermark
drain ("writeback mode"), and a closed-loop MLP-limited multi-core
front-end. Bank state is indexed by GLOBAL bank
``gb = (channel * n_ranks + rank) * n_banks + bank``; all-bank refresh
debt and the activate-drain it forces are tracked per global rank, so one
rank's REF_ab never stalls its siblings (the cross-rank staggering that
makes all-bank refresh tolerable in commodity controllers). The default
single-rank single-channel configuration reproduces the legacy flat model
bit-for-bit; `docs/tick-contract.md` is the normative spec.

Refresh decisions are NOT made here: every policy (the paper's REF_ab /
REF_pb / DARP / SARP / DSARP family plus registry extras like "elastic"
and "hira") lives in `perfbench.reference.dram.policy`, shared with the serving and
checkpoint engines. The simulator's job is timing fidelity — it keeps the
machine state (`BankState`, `BusState`, `WriteBuffer`, `RefreshLedger`),
builds a `MaintenanceView` after every event, and applies whatever
`Decision`s the registered policy returns (`_refresh_step` is the whole
adapter). Run any registered policy by name:

    run_policy("dsarp", density_gb=32, workload=wl)

Data-integrity invariant (asserted): every bank's refresh lag stays within
the JEDEC postpone/pull-in budget, i.e. |issued - due| <= 8 at all times.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from perfbench.reference.dram.policy import (ALL_BANKS, MaintenanceView, RefreshPolicy,
                               resolve_policy)
from perfbench.reference.dram.timing import DramTiming
from perfbench.reference.dram.workload import Workload


@dataclass(frozen=True)
class Policy:
    """Legacy flag record; kept so historical `DramSim(..., POLICIES[x])`
    call sites work. New code passes a registry name (or a
    `perfbench.reference.dram.policy` instance) instead."""
    name: str
    ideal: bool = False
    level: str = "pb"            # 'ab' | 'pb'
    ooo: bool = False            # DARP component 1
    wrp: bool = False            # DARP component 2
    sarp: bool = False           # subarray access-refresh parallelization


#: Legacy name->flags table (shim; `perfbench.reference.dram.policy.list_policies()` is
#: the authoritative catalogue, including post-paper additions).
POLICIES: dict[str, Policy] = {
    "ideal": Policy("ideal", ideal=True),
    "ref_ab": Policy("ref_ab", level="ab"),
    "ref_pb": Policy("ref_pb", level="pb"),
    "darp_ooo": Policy("darp_ooo", level="pb", ooo=True),
    "darp": Policy("darp", level="pb", ooo=True, wrp=True),
    "sarp_ab": Policy("sarp_ab", level="ab", sarp=True),
    "sarp_pb": Policy("sarp_pb", level="pb", sarp=True),
    "dsarp": Policy("dsarp", level="pb", ooo=True, wrp=True, sarp=True),
}


@dataclass
class SimResult:
    policy: str
    density_gb: int
    makespan: float
    core_finish: list
    reads_done: int
    writes_done: int
    avg_read_latency: float
    p99_read_latency: float
    refreshes_pb: int
    refreshes_ab: int
    row_hits: int
    row_misses: int
    energy: float
    max_abs_lag: int
    #: optional per-command occupancy timeline (`run_ticks(...,
    #: record_timeline=True)` only): {"refresh": [(bank, sub, start, end,
    #: kind)], "serves": [(t, bank, sub, row, is_write, done, arr)]} in
    #: ticks, sub == -1 for a whole-bank (non-SARP) refresh occupancy,
    #: arr == the tick the request entered its bank queue (so t - arr is
    #: the queueing stall the serving co-sim attributes back to
    #: requests). fig2 and the subarray overlap property tests are built
    #: on it.
    timeline: Optional[dict] = None
    #: optional DFI-style command trace (`record_commands=True` only): a
    #: `repro_torch.core.commands.CmdTrace` of every ACT/PRE/PREA/RD/WR/
    #: REF_ab/REF_pb the run issued, validated by
    #: `repro_torch.core.commands.validate_trace` and replayable bit-identically
    #: by `repro_torch.core.commands.replay_trace` (tick-contract section 7).
    commands: Optional[object] = None

    def weighted_speedup_vs(self, ideal: "SimResult") -> float:
        return float(np.mean([i / p for i, p in
                              zip(ideal.core_finish, self.core_finish)]))


class _Req:
    __slots__ = ("core", "idx", "is_write", "bank", "row", "sub", "t_arrive")

    def __init__(self, core, idx, is_write, bank, row, sub, t):
        self.core = core
        self.idx = idx
        self.is_write = is_write
        self.bank = bank
        self.row = row
        self.sub = sub
        self.t_arrive = t


# ---------------------------------------------------------------- machine
class BankState:
    """Per-bank occupancy and row-buffer state (arrays indexed by bank)."""

    def __init__(self, n_banks: int):
        # event-mode times are float64 by design (tick-contract section 5);
        # row/subarray ids are integral with -1 as the "none" sentinel
        self.free = np.zeros(n_banks, dtype=np.float64)       # busy until
        self.ref_until = np.zeros(n_banks, dtype=np.float64)  # refresh until
        self.ref_sub = np.full(n_banks, -1, dtype=np.int64)   # refreshing
        self.open_row = np.full(n_banks, -1, dtype=np.int64)
        self.open_sub = np.full(n_banks, -1, dtype=np.int64)


class BusState:
    """One channel's data bus: serialization point + read/write
    turnaround + rank-to-rank (ODT swap) turnaround."""

    def __init__(self):
        self.free = 0.0
        self.last_op_write = False
        self.last_rank = -1          # global rank of the last burst


class WriteBuffer:
    """Write buffer with high/low watermark drain and per-bank counts."""

    def __init__(self, n_banks: int, cap: int, hi: int, lo: int):
        self.buf: list[_Req] = []
        self.cap, self.hi, self.lo = cap, hi, lo
        self.per_bank = np.zeros(n_banks, dtype=int)
        self.drain = False

    def __len__(self):
        return len(self.buf)

    @property
    def full(self) -> bool:
        return len(self.buf) >= self.cap

    def add(self, r: _Req) -> None:
        self.buf.append(r)
        self.per_bank[r.bank] += 1
        if len(self.buf) >= self.hi:
            self.drain = True

    def remove(self, r: _Req) -> None:
        self.buf.remove(r)
        self.per_bank[r.bank] -= 1
        if self.drain and len(self.buf) <= self.lo:
            self.drain = False

    def for_bank(self, b: int) -> list[_Req]:
        return [r for r in self.buf if r.bank == b]


class RefreshLedger:
    """Refresh due/issued accounting: the per-(global-)bank postpone/
    pull-in ledger plus the PER-RANK all-bank pending counters (one
    rank's REF_ab debt/drain never touches its siblings)."""

    def __init__(self, timing: DramTiming):
        nb = timing.n_banks_total
        R = timing.n_ranks_total
        self.tREFI = timing.tREFI
        self.issued = np.zeros(nb, dtype=int)
        self.phase = (np.arange(nb, dtype=np.int64)
                      * timing.tREFI_pb)               # staggered schedule
        self.ref_sub_counter = np.zeros(nb, dtype=int)
        self.max_abs_lag = 0
        self.ab_pending = np.zeros(R, dtype=int)   # due-but-unstarted REFab
        self.rank_drain = np.zeros(R, dtype=bool)  # REF_ab: stop activates

    def due(self, b: int, t: float) -> int:
        if t < self.phase[b]:
            return 0
        return int(np.floor((t - self.phase[b]) / self.tREFI)) + 1

    def lag(self, b: int, t: float) -> int:
        return self.due(b, t) - int(self.issued[b])

    def lag_all(self, t: float) -> list[int]:
        due = np.floor((t - self.phase) / self.tREFI).astype(int) + 1
        due[t < self.phase] = 0
        return (due - self.issued).tolist()

    def record_issue(self, b: int, t: float) -> None:
        self.issued[b] += 1
        self.max_abs_lag = max(self.max_abs_lag, abs(self.lag(b, t)))


def energy_proxy(T: DramTiming, makespan_ns: float, reads: int, writes: int,
                 misses: int, ref_pb: int, ref_ab: int) -> float:
    """Energy proxy shared by `DramSim` and the batched sweep engine
    (arbitrary units; relative comparisons only). Coefficients chosen so
    refresh is ~8-15% of total at 32 Gb and background dominates —
    matching DRAM power breakdowns; the paper's energy win comes from the
    shorter runtime (background term). Every rank burns background/standby
    power for the whole run, so that term scales with `n_ranks_total`;
    `ref_ab` counts per-rank REF_ab starts (each covers one rank's
    `n_banks`). Assumptions + deliberate deviations from the paper's
    power model are documented in docs/figures.md."""
    return (0.5 * makespan_ns * T.n_ranks_total  # background + periphery
            + 12.0 * misses                      # activates + precharges
            + 6.0 * (reads + writes)
            + 0.15 * T.tRFC_pb * ref_pb          # refresh energy ~ latency
            + 0.15 * T.tRFC_ab * ref_ab * T.n_banks / 2)


class DramSim:
    """One simulation run. Construct then call .run().

    `policy` may be a registry name ("dsarp", "elastic", ...), a
    `perfbench.reference.dram.policy` instance, or a legacy `Policy` flag record.
    """

    def __init__(self, timing: DramTiming, workload: Workload,
                 policy: Union[str, Policy, RefreshPolicy], *,
                 wbuf_cap: int = 64, wbuf_hi: int = 48, wbuf_lo: int = 16):
        self.T = timing
        self.wl = workload
        # keep the spec so run() can resolve a FRESH policy instance each
        # time — policies carry mutable state (e.g. a round-robin pointer);
        # a caller passing an instance owns its lifecycle (one run each)
        self._policy_spec = policy
        self.policy: RefreshPolicy = resolve_policy(policy)
        self.wbuf_cap, self.wbuf_hi, self.wbuf_lo = wbuf_cap, wbuf_hi, wbuf_lo
        # demand spans every bank of the hierarchy (global bank indices)
        self.streams = workload.generate(timing.n_banks_total,
                                         timing.n_subarrays)
        bt = timing.n_banks_total
        self._rank_of = tuple(b // timing.n_banks for b in range(bt))
        self._chan_of = tuple(b // (timing.n_ranks * timing.n_banks)
                              for b in range(bt))
        self._rec = None             # event-mode command recorder (run())

    # --------------------------------------------------------- event heap
    def _push(self, t: float, kind: str, data=None) -> None:
        heapq.heappush(self._heap, (t, self._seq, kind, data))
        self._seq += 1

    # -------------------------------------------------- refresh mechanics
    def _start_pb_refresh(self, b: int, t: float) -> None:
        T, banks, led = self.T, self.banks, self.ledger
        start = max(t, float(banks.free[b]))
        banks.ref_until[b] = start + T.tRFC_pb
        if self.policy.sarp:
            banks.ref_sub[b] = led.ref_sub_counter[b] % T.n_subarrays
            if banks.open_sub[b] == banks.ref_sub[b]:
                banks.open_row[b] = -1  # refresh closes that subarray's row
        else:
            banks.ref_sub[b] = -1       # whole bank unavailable
            banks.open_row[b] = -1
        if self._rec is not None:
            tsub = int(banks.ref_sub[b])
            self._rec.emit(start, "PRE", b, sub=tsub)
            self._rec.emit(start + T.tRP, "REF_PB", b, sub=tsub, data=t)
        led.ref_sub_counter[b] += 1
        led.record_issue(b, t)
        self.stats["ref_pb"] += 1
        self._push(banks.ref_until[b], "sched")

    def _start_ab_refresh(self, gr: int, t: float) -> None:
        """All-bank refresh on global rank `gr` (its n_banks banks)."""
        T, banks, led = self.T, self.banks, self.ledger
        end = t + T.tRFC_ab
        if self._rec is not None:
            self._rec.emit_rank(t, "PREA", gr)
            self._rec.emit_rank(t + T.tRP, "REF_AB", gr, data=t)
        for b in range(gr * T.n_banks, (gr + 1) * T.n_banks):
            banks.ref_until[b] = end
            if self.policy.sarp:
                banks.ref_sub[b] = led.ref_sub_counter[b] % T.n_subarrays
                if banks.open_sub[b] == banks.ref_sub[b]:
                    banks.open_row[b] = -1
                led.ref_sub_counter[b] += 1
            else:
                banks.ref_sub[b] = -1
                banks.open_row[b] = -1
        led.ab_pending[gr] -= 1
        led.rank_drain[gr] = led.ab_pending[gr] > 0
        self.stats["ref_ab"] += 1
        self._push(end, "sched")

    def _ab_targets(self, rank: int) -> tuple:
        """Ranks an `ALL_BANKS` decision covers: an explicit rank (only
        while it actually has pending debt — a debt-free rank is skipped
        so a buggy policy cannot drive `ab_pending` negative), or — for
        the legacy `ANY_RANK` spelling — every rank with pending debt
        (exactly the old single-rank behavior at one rank)."""
        led = self.ledger
        if rank >= 0:
            return (rank,) if led.ab_pending[rank] > 0 else ()
        return tuple(int(r) for r in np.nonzero(led.ab_pending > 0)[0])

    def _bank_available(self, b: int, sub: int, t: float) -> bool:
        """Can a demand access to (b, sub) start at t?"""
        banks = self.banks
        if t < banks.free[b]:
            return False
        if t < banks.ref_until[b]:
            if not self.policy.sarp:
                return False
            if banks.ref_sub[b] == sub:
                return False            # same subarray as the refresh
        if self.ledger.rank_drain[self._rank_of[b]]:
            return False
        return True

    def _refresh_step(self, t: float) -> None:
        """The whole policy adapter: snapshot state into a MaintenanceView,
        apply whatever the registered policy decides."""
        pol, led, banks = self.policy, self.ledger, self.banks
        T = self.T
        nb = T.n_banks_total
        if pol.ideal:
            return
        if pol.level == "ab":
            if led.ab_pending.sum() <= 0:
                return
            view = MaintenanceView(
                now=t, n_banks=nb, budget=T.refresh_budget,
                lag=[0] * nb, demand=[0] * nb,
                ready=(banks.ref_until <= t).tolist(),
                idle=(banks.free <= t).tolist(),
                write_window=self.wbuf.drain, max_issues=1,
                rank_due=int(led.ab_pending.sum()),
                rank_quiet=bool((banks.free <= t).all()
                                and (banks.ref_until <= t).all()),
                n_ranks=T.n_ranks, n_channels=T.n_channels,
                rank_of=self._rank_of, channel_of=self._chan_of,
                ranks_due=tuple(int(x) for x in led.ab_pending))
            for d in pol.select(view):
                if d.bank == ALL_BANKS:
                    for gr in self._ab_targets(d.rank):
                        self._start_ab_refresh(gr, t)
            return
        # ---- per-bank policies
        wb = self.wbuf.per_bank
        view = MaintenanceView(
            now=t, n_banks=nb, budget=T.refresh_budget,
            lag=led.lag_all(t),
            demand=[len(self.read_q[b]) + int(wb[b]) for b in range(nb)],
            ready=(banks.ref_until <= t).tolist(),
            idle=(banks.free <= t).tolist(),
            write_window=self.wbuf.drain, max_issues=1,
            n_ranks=T.n_ranks, n_channels=T.n_channels,
            rank_of=self._rank_of, channel_of=self._chan_of)
        for d in pol.select(view):
            self._start_pb_refresh(d.bank, t)

    # --------------------------------------------------- demand service
    def _pick_and_start(self, t: float) -> bool:
        T, banks, wbuf = self.T, self.banks, self.wbuf
        started = False
        order = np.argsort(banks.free)   # favor longest-idle banks
        for b in order:
            q = self.read_q[b]
            serving_writes = wbuf.drain
            reqs = wbuf.for_bank(b) if serving_writes else q
            if not reqs:
                # outside drain mode, opportunistically serve writes when
                # a bank has no reads and buffer is non-trivially full
                if not serving_writes and not q and len(wbuf) > self.wbuf_lo:
                    reqs = wbuf.for_bank(b)
                if not reqs:
                    continue
            # FR-FCFS: row hit first, then oldest
            hit = [r for r in reqs if r.row == banks.open_row[b]]
            r = hit[0] if hit else reqs[0]
            if not self._bank_available(b, r.sub, t):
                continue
            is_hit = r.row == banks.open_row[b]
            lat = T.row_hit if is_hit else T.row_miss
            if self.policy.sarp and t < banks.ref_until[b]:
                lat += T.sarp_penalty    # peripheral sharing penalty
            # the bank's channel bus: serialization + turnaround
            bus = self.buses[self._chan_of[b]]
            gr = self._rank_of[b]
            turn = 0.0
            if r.is_write != bus.last_op_write:
                turn = T.tRTW if r.is_write else T.tWTR
            if 0 <= bus.last_rank != gr:
                turn += T.tRTR           # rank-to-rank bus handoff
            data_start = max(t + lat - T.tBL, bus.free + turn)
            done = data_start + T.tBL
            banks.free[b] = done + (T.tWR if r.is_write else 0.0)
            if banks.free[b] > done:
                self._push(banks.free[b], "sched")  # wake at tWR end
            bus.free = done
            bus.last_op_write = r.is_write
            bus.last_rank = gr
            if self._rec is not None:
                if not is_hit:
                    if banks.open_row[b] != -1:
                        self._rec.emit(t, "PRE", int(b), sub=r.sub)
                    self._rec.emit(t, "ACT", int(b), sub=r.sub, row=r.row)
                self._rec.emit(t, "WR" if r.is_write else "RD", int(b),
                               sub=r.sub, row=r.row, data=done)
            banks.open_row[b] = r.row
            banks.open_sub[b] = r.sub
            self.stats["hits" if is_hit else "misses"] += 1
            if r.is_write:
                wbuf.remove(r)
                self.stats["writes"] += 1
            else:
                q.remove(r)
                self.stats["reads"] += 1
                self.read_lat.append(done - r.t_arrive)
            self._push(done, "done", r)
            started = True
        return started

    # ----------------------------------------------------- core front-end
    def _core_try(self, c: int, t: float) -> None:
        s = self.streams[c]
        n = len(s["is_write"])
        while self.next_idx[c] < n:
            i = self.next_idx[c]
            if t < self.next_issue[c]:
                self._push(self.next_issue[c], "core", c)
                return
            if s["is_write"][i]:
                if self.wbuf.full:
                    self.blocked_write[c] = True
                    return
                r = _Req(c, i, True, int(s["bank"][i]), int(s["row"][i]),
                         int(s["subarray"][i]), t)
                self.wbuf.add(r)
                self._complete_one(c, t)
            else:
                if self.out_reads[c] >= self.wl.mlp:
                    return
                r = _Req(c, i, False, int(s["bank"][i]), int(s["row"][i]),
                         int(s["subarray"][i]), t)
                self.read_q[r.bank].append(r)
                self.out_reads[c] += 1
            self.next_idx[c] += 1
            self.next_issue[c] = t + s["think"][i]

    def _complete_one(self, c: int, t: float) -> None:
        self.remaining[c] -= 1
        if self.remaining[c] == 0:
            self.finish[c] = t

    # ------------------------------------------------------------------ run
    def run_ticks(self, dt_ns: float = 6.0,
                  horizon: Optional[int] = None, *,
                  record_timeline: bool = False,
                  record_commands: bool = False) -> SimResult:
        """Closed-loop run on the sweep engine's integer tick contract.

        The event-heap `run()` above is the float timing-fidelity mode;
        this method instead drives the SAME workload streams and the SAME
        registered policy through the integer tick contract the sweep
        engine's closed-loop mode implements (see
        `perfbench.reference.dram.tickutil`'s module docstring) — making `DramSim`
        the differential-conformance target for every fast backend:
        `tests/test_conformance.py` asserts the batched/jax/pallas grids
        are **bit-identical** to looping this method per cell.

        Refresh occupancy and row-activation state are SUBARRAY-granular
        (`ref_until_s[b][s]` / `open_row_s[b][s]`, `T.n_subarrays` wide):
        a SARP refresh occupies one subarray while siblings keep serving
        (at `SARP_PEN`); a non-SARP refresh occupies all of them. An
        `hra`-trait policy additionally starts a per-bank refresh at the
        decision tick — hidden behind the in-flight access — whenever the
        target subarray differs from the bank's active subarray. With
        `n_subarrays == 1` every rule degenerates to the bank-granular
        contract bit-for-bit.

        Deliberately an independent implementation: per-request Python
        tuples, per-bank lists, and the shared `MaintenanceLedger`
        (`perfbench.reference.dram.policy.ledger`) for the due/issued accounting the
        stacked backends carry as `[G, B]` arrays. The known, named
        divergences from `run()` (per-bank FIFO order, symmetric
        turnaround, tick quantization, no separate bus serialization
        point) are asserted as divergences in the conformance tests, not
        papered over.

        `record_timeline=True` additionally fills `SimResult.timeline`
        with every refresh occupancy interval and every serve (fig2's
        data source; ~O(commands) memory).

        `record_commands=True` additionally fills `SimResult.commands`
        with a DFI-style `repro_torch.core.commands.CmdTrace` of every
        ACT/PRE/PREA/RD/WR/REF command the run issues, plus the raw
        demand streams for bit-identical replay (tick-contract section
        7); when False the tick loop pays nothing for it.
        """
        from perfbench.reference.dram.policy.ledger import MaintenanceLedger
        from perfbench.reference.dram.workload import quantize_streams
        from perfbench.reference.dram.arbiter import (AGE_CAP, OCC_CAP, W_HIT,
                                              W_NOCONF, W_OCC, W_WRITE)
        from perfbench.reference.dram.tickutil import (MAX_LAT_TICKS, _p99_ticks,
                                             _scalar_refreshing_sub)

        pol = resolve_policy(self._policy_spec)
        T = self.T
        B, S = T.n_banks_total, T.n_subarrays
        NB, R, NC = T.n_banks, T.n_ranks_total, T.n_channels
        RB = T.n_ranks * NB              # banks per channel

        def tkq(ns: float) -> int:        # same quantization as TickTiming
            return max(1, int(ns / dt_ns + 0.5))

        REFI = tkq(T.tREFI)
        REFI_PB = max(1, REFI // B)
        RFC_PB, RFC_AB = tkq(T.tRFC_pb), tkq(T.tRFC_ab)
        HIT, MISS = tkq(T.row_hit), tkq(T.row_miss)
        WR, TURN = tkq(T.tWR), tkq(T.tWTR)
        RTR = tkq(T.tRTR)
        SARP_PEN = tkq(T.sarp_penalty)
        TRP = tkq(T.tRP)
        budget = T.refresh_budget
        rank_phase = [gr * (REFI // R) for gr in range(R)]

        streams = quantize_streams(self.streams, dt_ns)
        C, mlp = len(streams), self.wl.mlp
        n_req = [len(s["is_write"]) for s in streams]
        CAP, HI, LO = self.wbuf_cap, self.wbuf_hi, self.wbuf_lo

        rec = None
        if record_commands:
            raise NotImplementedError("the frozen reference records no commands")

        led = MaintenanceLedger(B, interval=float(REFI), budget=budget,
                                stagger=False)
        led.phase = [float(b * REFI_PB) for b in range(B)]

        if horizon is None:
            think_span = max((int(s["think"].sum()) for s in streams),
                             default=0)
            horizon = (think_span + 4 * sum(n_req)
                       * (MISS + WR + TURN + 2) + 8 * RFC_AB + 64)
        horizon = min(horizon, 1 << 28)

        q: list[list[tuple]] = [[] for _ in range(B)]
        next_idx = [0] * C
        next_issue = [0] * C
        out_reads = [0] * C
        remaining = list(n_req)
        finish = [0 if remaining[c] == 0 else -1 for c in range(C)]
        n_finished = sum(1 for c in range(C) if remaining[c] == 0)
        comp: list[tuple[int, int]] = []

        bank_free = [0] * B
        ref_until_s = [[0] * S for _ in range(B)]    # per-subarray refresh
        open_row_s = [[-1] * S for _ in range(B)]    # per-subarray open row
        open_sub = [-1] * B
        ctr = [0] * B
        wpend = 0
        drain = False
        last_op = [False] * NC           # per-channel bus turnaround state
        last_rank = [-1] * NC            # per-channel last-served rank
        ab_pending = [0] * R             # per-rank all-bank refresh debt
        rank_drain = [False] * R
        maxlag = 0

        reads = writes = hits = misses = refpb = refab = 0
        lat_sum = 0
        hist = np.zeros(MAX_LAT_TICKS + 1, np.int32)
        last_done = 0
        hra = bool(getattr(pol, "hra", False))
        timeline = ({"refresh": [], "serves": []} if record_timeline
                    else None)

        def start_pb(b: int, t: int):
            nonlocal refpb, maxlag
            ns_ = ctr[b] % S
            # hidden row activation: a refresh targeting a subarray other
            # than the bank's active one issues NOW, behind the in-flight
            # access, instead of waiting for the bank to go idle
            start = t if (hra and ns_ != open_sub[b]) else \
                max(t, bank_free[b])
            end = start + RFC_PB
            if rec is not None:
                tsub = ns_ if pol.sarp else -1
                rec.emit(start, "PRE", b, sub=tsub)
                rec.emit(start + TRP, "REF_PB", b, sub=tsub, data=t)
            if pol.sarp:
                ref_until_s[b][ns_] = end
                open_row_s[b][ns_] = -1
                if timeline is not None:
                    timeline["refresh"].append((b, ns_, start, end, "pb"))
            else:
                for s_ in range(S):
                    ref_until_s[b][s_] = end
                    open_row_s[b][s_] = -1
                if timeline is not None:
                    timeline["refresh"].append((b, -1, start, end, "pb"))
            ctr[b] += 1
            refpb += 1
            maxlag = max(maxlag, abs(led.lag(b, float(t))))

        def start_ab(gr: int, t: int):
            nonlocal refab
            end = t + RFC_AB
            if rec is not None:
                rec.emit_rank(t, "PREA", gr)
                rec.emit_rank(t + TRP, "REF_AB", gr, data=t)
            for b in range(gr * NB, (gr + 1) * NB):
                if pol.sarp:
                    ns_ = ctr[b] % S
                    ref_until_s[b][ns_] = end
                    open_row_s[b][ns_] = -1
                    ctr[b] += 1
                    if timeline is not None:
                        timeline["refresh"].append((b, ns_, t, end, "ab"))
                else:
                    for s_ in range(S):
                        ref_until_s[b][s_] = end
                        open_row_s[b][s_] = -1
                    if timeline is not None:
                        timeline["refresh"].append((b, -1, t, end, "ab"))
            ab_pending[gr] -= 1
            rank_drain[gr] = ab_pending[gr] > 0
            refab += 1

        t = 0
        while n_finished < C and t < horizon:
            # 0: outstanding-read completions
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
            # 1: core issue (one per core per tick, core order)
            for c in range(C):
                i = next_idx[c]
                if i >= n_req[c] or t < next_issue[c]:
                    continue
                s = streams[c]
                if s["is_write"][i]:
                    if wpend >= CAP:
                        continue
                    q[s["bank"][i]].append(
                        (t, int(s["row"][i]), int(s["subarray"][i]),
                         True, c))
                    wpend += 1
                    remaining[c] -= 1
                    if remaining[c] == 0:
                        finish[c] = t
                        n_finished += 1
                else:
                    if out_reads[c] >= mlp:
                        continue
                    q[s["bank"][i]].append(
                        (t, int(s["row"][i]), int(s["subarray"][i]),
                         False, c))
                    out_reads[c] += 1
                next_idx[c] = i + 1
                next_issue[c] = t + int(s["think"][i])
            if n_finished >= C:
                break
            # 2: write-drain watermark
            if wpend >= HI:
                drain = True
            # 3: rank refresh debt (per-rank, staggered tREFI/R apart)
            if not pol.ideal and pol.level == "ab":
                for gr in range(R):
                    if (t > rank_phase[gr]
                            and (t - rank_phase[gr]) % REFI == 0):
                        ab_pending[gr] += 1
                        rank_drain[gr] = True
            # 4: policy decision (pb lag accounting via the shared ledger)
            if not pol.ideal:
                if pol.level == "ab":
                    if sum(ab_pending) > 0:
                        quiet = (all(f <= t for f in bank_free)
                                 and all(ru <= t for rb in ref_until_s
                                         for ru in rb))
                        view = MaintenanceView(
                            now=float(t), n_banks=B, budget=budget,
                            lag=[0] * B, demand=[0] * B,
                            ready=[all(ru <= t for ru in ref_until_s[b])
                                   for b in range(B)],
                            idle=[bank_free[b] <= t for b in range(B)],
                            write_window=drain,
                            max_issues=1, rank_due=sum(ab_pending),
                            rank_quiet=quiet,
                            n_ranks=T.n_ranks, n_channels=NC,
                            rank_of=self._rank_of,
                            channel_of=self._chan_of,
                            ranks_due=tuple(ab_pending),
                            n_subarrays=S,
                            next_ref_sub=tuple(ctr[b] % S
                                               for b in range(B)),
                            refreshing_sub=tuple(
                                _scalar_refreshing_sub(ref_until_s[b], t)
                                for b in range(B)),
                            active_sub=tuple(open_sub))
                        for dec in pol.select(view):
                            if dec.bank == ALL_BANKS:
                                if dec.rank >= 0:
                                    # debt-free ranks are skipped so a
                                    # buggy policy can't go negative
                                    if ab_pending[dec.rank] > 0:
                                        start_ab(dec.rank, t)
                                else:
                                    for gr in range(R):
                                        if ab_pending[gr] > 0:
                                            start_ab(gr, t)
                else:
                    view = led.view(
                        float(t),
                        demand=[len(q[b]) for b in range(B)],
                        write_window=drain,
                        ready=[all(ru <= t for ru in ref_until_s[b])
                               for b in range(B)],
                        idle=[bank_free[b] <= t for b in range(B)],
                        n_ranks=T.n_ranks, n_channels=NC,
                        rank_of=self._rank_of, channel_of=self._chan_of,
                        n_subarrays=S,
                        next_ref_sub=tuple(ctr[b] % S for b in range(B)),
                        refreshing_sub=tuple(
                            _scalar_refreshing_sub(ref_until_s[b], t)
                            for b in range(B)),
                        active_sub=tuple(open_sub))
                    decs = pol.select(view)
                    for dec in decs:
                        if dec.bank == ALL_BANKS:
                            raise ValueError(
                                f"policy {pol.name!r} returned ALL_BANKS "
                                "from a per-bank (level='pb') decision "
                                "point")
                    for b in led.apply(decs, float(t)):
                        start_pb(b, t)
            # 5: occupancy-aware arbitration (one start per CHANNEL per
            # tick; scores snapshot `drain` before any serve this tick)
            drain_arb = drain
            for ch in range(NC):
                best, best_score = -1, -1
                for b in range(ch * RB, (ch + 1) * RB):
                    if not q[b]:
                        continue
                    if rank_drain[b // NB]:
                        continue
                    arr, row, sub, isw, core = q[b][0]
                    if bank_free[b] > t:
                        continue
                    # the head request's OWN subarray must be refresh-free
                    # (a non-SARP refresh marks every subarray, so the
                    # whole bank blocks; a SARP refresh only its target)
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
                    lat = HIT if hit else MISS
                    if pol.sarp and any(ru > t for ru in ref_until_s[b]):
                        lat += SARP_PEN  # peripheral sharing penalty
                    if isw != last_op[ch]:
                        lat += TURN
                    if 0 <= last_rank[ch] != gr:
                        lat += RTR       # rank-to-rank bus handoff
                    done = t + lat
                    bank_free[b] = done + (WR if isw else 0)
                    last_op[ch] = isw
                    last_rank[ch] = gr
                    if rec is not None:
                        if not hit:
                            if open_row_s[b][sub] != -1:
                                rec.emit(t, "PRE", b, sub=sub)
                            rec.emit(t, "ACT", b, sub=sub, row=row)
                        rec.emit(t, "WR" if isw else "RD", b,
                                 sub=sub, row=row, data=done)
                    open_row_s[b][sub] = row
                    open_sub[b] = sub
                    if timeline is not None:
                        timeline["serves"].append(
                            (t, b, sub, row, isw, done, arr))
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
        makespan = float(max(fin, default=0)) * dt_ns
        e = energy_proxy(T, makespan, reads, writes, misses, refpb, refab)
        return SimResult(
            policy=pol.name, density_gb=T.density_gb, makespan=makespan,
            core_finish=[float(int(f)) * dt_ns for f in fin],
            reads_done=reads, writes_done=writes,
            avg_read_latency=(dt_ns * lat_sum / reads) if reads else 0.0,
            p99_read_latency=dt_ns * _p99_ticks(hist, reads),
            refreshes_pb=refpb, refreshes_ab=refab,
            row_hits=hits, row_misses=misses, energy=e,
            max_abs_lag=maxlag, timeline=timeline,
            commands=(rec.trace(end=int(max(fin, default=0)),
                                demand={"mlp": int(mlp),
                                        "streams": self.streams})
                      if rec is not None else None),
        )

    def run(self, *, record_commands: bool = False) -> SimResult:
        self.policy = resolve_policy(self._policy_spec)
        T, pol = self.T, self.policy
        nb, ncore = T.n_banks_total, self.wl.n_cores
        R = T.n_ranks_total

        self._rec = None
        if record_commands:
            # event-mode trace: float-ns clock, sequencing/budget rules
            # only (tick-contract section 5 names the divergences)
            raise NotImplementedError("the frozen reference records no commands")

        # ---- machine state
        self._heap: list = []
        self._seq = 0
        self.banks = BankState(nb)
        self.buses = [BusState() for _ in range(T.n_channels)]
        self.wbuf = WriteBuffer(nb, self.wbuf_cap, self.wbuf_hi, self.wbuf_lo)
        self.ledger = RefreshLedger(T)
        self.read_q: list[list[_Req]] = [[] for _ in range(nb)]

        # ---- core state
        self.next_idx = np.zeros(ncore, dtype=int)
        self.out_reads = np.zeros(ncore, dtype=int)
        self.next_issue = np.zeros(ncore, dtype=np.float64)  # event times
        self.finish = np.full(ncore, np.nan, dtype=np.float64)
        self.remaining = np.array([len(s["is_write"]) for s in self.streams])
        self.blocked_write = np.zeros(ncore, dtype=bool)

        self.read_lat: list[float] = []
        self.stats = dict(reads=0, writes=0, hits=0, misses=0,
                          ref_pb=0, ref_ab=0)

        # ---- event seeding
        for c in range(ncore):
            self._push(0.0, "core", c)
        if not pol.ideal:
            if pol.level == "ab":
                # per-rank debt, staggered tREFI/R apart across ranks
                for gr in range(R):
                    self._push(T.tREFI + gr * T.tREFI / R, "ab_due", gr)
            # pb due times are computed analytically via the ledger; the
            # periodic tick only guarantees postponed refreshes get retried
            self._push(T.tREFI_pb, "tick")

        t = 0.0
        guard = 0
        while self._heap and np.isnan(self.finish).any():
            t, _, kind, data = heapq.heappop(self._heap)
            guard += 1
            if guard > 20_000_000:
                raise RuntimeError("simulator runaway")
            if kind == "ab_due":
                self.ledger.ab_pending[data] += 1
                self.ledger.rank_drain[data] = True
                self._push(t + T.tREFI, "ab_due", data)
            elif kind == "tick":
                self._push(t + T.tREFI_pb, "tick")
            elif kind == "done":
                r: _Req = data
                if not r.is_write:
                    self.out_reads[r.core] -= 1
                    self._complete_one(r.core, t)
                    self._core_try(r.core, t)
                else:
                    # drain progress may unblock writers
                    for c in range(ncore):
                        if self.blocked_write[c] and not self.wbuf.full:
                            self.blocked_write[c] = False
                            self._core_try(c, t)
            elif kind == "core":
                self._core_try(data, t)
            # after every event: refresh mgmt then demand scheduling
            self._refresh_step(t)
            self._pick_and_start(t)

        makespan = float(np.nanmax(self.finish))
        stats = self.stats
        e = energy_proxy(T, makespan, stats["reads"], stats["writes"],
                         stats["misses"], stats["ref_pb"], stats["ref_ab"])
        rl = np.array(self.read_lat) if self.read_lat else np.array([0.0])
        return SimResult(
            policy=pol.name, density_gb=T.density_gb, makespan=makespan,
            core_finish=[float(x) for x in self.finish],
            reads_done=stats["reads"], writes_done=stats["writes"],
            avg_read_latency=float(rl.mean()),
            p99_read_latency=float(np.percentile(rl, 99)),
            refreshes_pb=stats["ref_pb"], refreshes_ab=stats["ref_ab"],
            row_hits=stats["hits"], row_misses=stats["misses"], energy=e,
            max_abs_lag=int(self.ledger.max_abs_lag),
            commands=(self._rec.trace(end=makespan)
                      if self._rec is not None else None),
        )


def run_policy(policy_name: str, density_gb: int, workload: Workload,
               **kw) -> SimResult:
    """Run any registered policy (see `perfbench.reference.dram.policy.list_policies()`)
    at the given density."""
    from perfbench.reference.dram.timing import timing_for_density
    return DramSim(timing_for_density(density_gb), workload,
                   policy_name, **kw).run()
