"""The pluggable refresh/maintenance policy protocol.

A *policy* answers one question — "which banks get maintenance NOW?" —
against a `MaintenanceView` of the system, and returns `Decision`s. The
same policy object drives every engine in the repo:

  * `DramSim` (core/refresh/sim.py): timing-accurate DRAM refresh, where a
    bank is a DRAM bank and maintenance is a REF command,
  * `EngineCore` (serving/engine.py): KV-cache page-group compression via
    the shared `MaintenanceLedger` (core/policy/ledger.py) — demand is
    attended page-groups, pressure is staging occupancy,
  * `DarpScheduler` (core/scheduler/darp.py): the compat wrapper over the
    ledger for generic framework "banks" (checkpoint shard-banks and the
    legacy serving spelling),
  * anything new: implement `select()` once, `@register_policy("name")`,
    and every engine can resolve it by name.

The data-integrity contract every policy must keep: for every bank, at all
times, -budget <= due(now) - issued <= budget (the JEDEC postpone/pull-in
budget). The forced path (issue when lag hits +budget) is the standard way
to honour the upper edge; never issuing below lag > -budget honours the
lower one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, Sequence, runtime_checkable

#: `Decision.bank` value for a rank-level (all-bank) refresh.
ALL_BANKS = -1

#: `Decision.rank` value meaning "every rank with pending all-bank debt"
#: (the legacy single-rank spelling: with one rank it IS rank 0).
ANY_RANK = -1


@dataclass(frozen=True)
class Decision:
    """One maintenance command: refresh `bank` (or a whole rank).

    `rank` only matters when `bank == ALL_BANKS`: it names the global
    rank (channel * n_ranks + rank) whose banks the all-bank refresh
    covers. The default `ANY_RANK` keeps legacy single-rank policies
    working — engines expand it to every rank with pending debt, which
    with one rank is exactly the old behavior.
    """
    bank: int                    # bank index, or ALL_BANKS
    forced: bool = False         # postpone budget exhausted
    reason: str = ""             # optional trace label
    rank: int = ANY_RANK         # global rank for ALL_BANKS decisions


@dataclass
class MaintenanceView:
    """Snapshot of everything a policy may observe when deciding.

    Engines build this once per decision point; policies must treat it as
    read-only. `lag[b] = due(now) - issued` is the canonical urgency signal
    (>0 owed, <0 pulled in). `ready[b]` means a refresh may *start* on bank
    b now (it is not mid-refresh); `idle[b]` means no demand access is in
    flight (generic engines pass all-True for both). `rank_due`/`rank_quiet`
    only matter to rank-level (all-bank) policies in the timing simulator.
    """
    now: float
    n_banks: int
    budget: int
    lag: Sequence[int]
    demand: Sequence[int]
    ready: Sequence[bool]
    idle: Sequence[bool]
    write_window: bool = False   # write-drain / write-phase in progress
    max_issues: int = 1          # non-forced issues allowed this call
    rank_due: int = 0            # pending all-bank refreshes (sim only;
    #   TOTAL across ranks when the hierarchy fields below are set)
    rank_quiet: bool = True      # every bank drained; REF_ab may start
    pressure: float = 0.0        # write-buffer fill fraction in [0, 1]:
    #   DRAM sim = write-buffer occupancy; serving EngineCore = KV staging
    #   pressure (1.0 means the forced red-line is imminent). Policies may
    #   use it to modulate how aggressively they repay lag; engines that
    #   have no buffer analogue leave it 0.
    slo_pressure: float = 0.0    # SLO deadline pressure in [0, 1]: the
    #   fraction of live requests whose TTFT/TPOT headroom is exhausted
    #   (serving EngineCore computes it from EngineConfig's
    #   ttft_slo_rounds/tpot_slo_rounds). Policies may postpone
    #   maintenance while it is high and repay in the valleys; engines
    #   with no request-deadline analogue (the tick simulators, the
    #   checkpoint scheduler) leave it 0, so consuming it is
    #   conformance-safe by construction.

    # ---- hierarchy (channel, rank, bank) — tick engines only ----------
    # Generic engines (serving, checkpoint) leave the defaults, which
    # describe a flat single-rank single-channel view. `n_banks` is
    # always the TOTAL bank count; `rank_of[b]`/`channel_of[b]` map a
    # global bank index to its global rank (channel * n_ranks + rank)
    # and channel. `ranks_due[gr]` is the per-rank all-bank refresh debt
    # — non-empty iff the engine tracks the hierarchy, so policies can
    # key multi-rank behavior on `bool(view.ranks_due)`.
    n_ranks: int = 1             # ranks per channel
    n_channels: int = 1
    rank_of: Sequence[int] = ()      # [n_banks] global rank per bank
    channel_of: Sequence[int] = ()   # [n_banks] channel per bank
    ranks_due: Sequence[int] = ()    # [n_ranks_total] per-rank ab debt

    # ---- subarray plane (bank, subarray) — tick engines only ----------
    # One level below banks: per-subarray refresh occupancy and row
    # activation. Generic engines leave the defaults (one subarray per
    # bank, no per-subarray signals). `next_ref_sub[b]` is the subarray a
    # SARP per-bank refresh on bank b would target NEXT (the round-robin
    # pointer); `refreshing_sub[b]` is the single subarray of bank b
    # currently mid-refresh, or -1 when none or more than one (an all-
    # bank refresh occupies every subarray); `active_sub[b]` is the
    # subarray holding bank b's open row (-1 while the bank is closed).
    n_subarrays: int = 1             # subarrays per bank
    next_ref_sub: Sequence[int] = ()     # [n_banks] next SARP target
    refreshing_sub: Sequence[int] = ()   # [n_banks] mid-refresh subarray
    active_sub: Sequence[int] = ()       # [n_banks] open-row subarray

    @property
    def n_ranks_total(self) -> int:
        return self.n_ranks * self.n_channels

    def rank_banks(self, gr: int) -> list:
        """Global bank indices of global rank `gr`."""
        if not self.rank_of:
            return list(range(self.n_banks))
        return [b for b in range(self.n_banks) if self.rank_of[b] == gr]

    def rank_is_quiet(self, gr: int) -> bool:
        """Every bank of rank `gr` is refresh-ready and demand-idle (the
        per-rank generalization of the legacy `rank_quiet`)."""
        return all(self.ready[b] and self.idle[b]
                   for b in self.rank_banks(gr))

    def channel_is_clear(self, ch: int) -> bool:
        """No bank on channel `ch` is mid-refresh — an all-bank refresh
        started now would not overlap another on the same channel."""
        if not self.channel_of:
            return all(self.ready)
        return all(self.ready[b] for b in range(self.n_banks)
                   if self.channel_of[b] == ch)


@runtime_checkable
class RefreshPolicy(Protocol):
    """Protocol all registered policies satisfy.

    Traits consumed by the engines:
      name  : registry name (also stamped on SimResult),
      level : 'pb' per-bank decisions | 'ab' rank-level refresh,
      sarp  : subarray access-refresh parallelization (the timing sim
              models per-subarray availability during a refresh),
      ideal : no maintenance at all (upper-bound baseline).
    """
    name: str
    level: str
    sarp: bool
    ideal: bool

    def select(self, view: MaintenanceView) -> list[Decision]:
        """Return the maintenance decisions for this instant.

        The caller MUST apply every returned decision (each one is recorded
        against the bank's issued count). Policies may keep mutable state
        across calls (e.g. a round-robin pointer): one policy instance
        drives exactly one engine run.
        """
        ...


class PolicyBase:
    """Convenience base: trait defaults + the shared forced-refresh sweep.

    The four traits every engine consumes (see `RefreshPolicy`):
      level : 'pb' = per-bank decisions; 'ab' = rank-level (all-bank)
              refresh via `Decision(ALL_BANKS)`,
      sarp  : subarray access-refresh parallelization — the timing sim
              serves other-subarray accesses during a refresh (with a
              peripheral-sharing penalty), and the sweep engine's
              arbitration lets non-conflicting heads through,
      ideal : no maintenance at all; engines skip `select()` entirely,
      name  : registry name, stamped on results.
    Policies that react to write drains read `view.write_window`
    (DARP's WRP component, hira's pull-in); docstrings in `paper.py` /
    `extras.py` state each registered policy's paper section and traits.
    """
    name = "base"
    level = "pb"
    sarp = False
    ideal = False

    def select(self, view: MaintenanceView) -> list[Decision]:
        raise NotImplementedError

    # ------------------------------------------------------------ helpers
    @staticmethod
    def _forced(view: MaintenanceView, lag: list[int],
                picks: list[Decision]) -> None:
        """Issue on every bank whose postpone budget is exhausted — the
        data-integrity guarantee; overrides demand AND max_issues."""
        for b in range(view.n_banks):
            if lag[b] >= view.budget and view.ready[b]:
                picks.append(Decision(b, forced=True, reason="budget edge"))
                lag[b] -= 1

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"
