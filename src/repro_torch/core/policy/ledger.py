"""The due/issued maintenance ledger + `MaintenanceView` builder.

Every generic engine (serving `EngineCore`, checkpoint engine via the
`DarpScheduler` compat wrapper) needs the same bookkeeping around a
policy: track how many maintenance operations each "bank" owes
(`due - issued`, the JEDEC-style lag), build a read-only
`MaintenanceView` snapshot at each decision point, and record whatever
the policy returns so the ±budget contract stays checkable. That
bookkeeping lives here, once.

Usage (what `EngineCore._maintenance` does):

    led = MaintenanceLedger(n_banks=8, interval=4.0, budget=8)
    view = led.view(now, demand=demand, write_window=draining,
                    ready=ready, pressure=pressure)
    banks = led.apply(policy.select(view), now)   # recorded as issued
    for b in banks: ...perform the maintenance...

The caller MUST perform the maintenance for every bank returned by
`apply` — the ledger has already counted it as issued. Time is
caller-defined (rounds, steps, seconds) and strictly non-decreasing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.policy.base import (ALL_BANKS, Decision, MaintenanceView)


@dataclass
class BankLedgerState:
    issued: int = 0
    last_issue_time: float = -1.0


class MaintenanceLedger:
    """Phase/due/issued bookkeeping for one engine run.

    `stagger=True` spreads per-bank phases like LPDDR's tREFI_pb so
    maintenance never bunches up at t=0.
    """

    def __init__(self, n_banks: int, interval: float, *,
                 budget: int = 8, stagger: bool = True):
        assert n_banks >= 1 and interval > 0 and budget >= 1
        self.n_banks = n_banks
        self.interval = float(interval)
        self.budget = budget
        self.banks = [BankLedgerState() for _ in range(n_banks)]
        self.phase = [(i * self.interval / n_banks if stagger else 0.0)
                      for i in range(n_banks)]
        self._last_now = float("-inf")

    # ------------------------------------------------------------- queries
    def due(self, b: int, now: float) -> int:
        if now < self.phase[b]:
            return 0
        return int((now - self.phase[b]) // self.interval) + 1

    def lag(self, b: int, now: float) -> int:
        """due - issued; >0 means owed, <0 means pulled in."""
        return self.due(b, now) - self.banks[b].issued

    def overdue(self, now: float) -> list[int]:
        return [b for b in range(self.n_banks) if self.lag(b, now) > 0]

    # -------------------------------------------------------- view + apply
    def view(self, now: float, *, demand: Sequence[int],
             write_window: bool = False, max_issues: int = 1,
             ready: Optional[Sequence[bool]] = None,
             idle: Optional[Sequence[bool]] = None,
             pressure: float = 0.0, slo_pressure: float = 0.0,
             rank_due: int = 0,
             rank_quiet: bool = True, n_ranks: int = 1,
             n_channels: int = 1, rank_of: Sequence[int] = (),
             channel_of: Sequence[int] = (),
             ranks_due: Sequence[int] = (),
             n_subarrays: int = 1,
             next_ref_sub: Sequence[int] = (),
             refreshing_sub: Sequence[int] = (),
             active_sub: Sequence[int] = ()) -> MaintenanceView:
        """Build the read-only snapshot a policy decides against.

        demand[b]: pending demand work on bank b. `ready`/`idle` default
        to all-True (generic engines can always start maintenance);
        `pressure` is the engine's write-buffer/staging fill fraction.
        `rank_due`/`rank_quiet` only matter to rank-level (all-bank)
        policies — engines that track rank refresh debt themselves (the
        tick simulators) pass them through here, along with the
        [channel, rank, bank] hierarchy fields (`rank_of`/`channel_of`/
        `ranks_due`) and, one level further down, the per-subarray
        signals (`n_subarrays`/`next_ref_sub`/`refreshing_sub`/
        `active_sub`; see docs/tick-contract.md).
        """
        assert len(demand) == self.n_banks
        assert now >= self._last_now, "time must be monotonic"
        self._last_now = now
        return MaintenanceView(
            now=now, n_banks=self.n_banks, budget=self.budget,
            lag=[self.lag(b, now) for b in range(self.n_banks)],
            demand=list(demand),
            ready=list(ready) if ready is not None else [True] * self.n_banks,
            idle=list(idle) if idle is not None else [True] * self.n_banks,
            write_window=write_window, max_issues=max_issues,
            pressure=float(pressure), slo_pressure=float(slo_pressure),
            rank_due=int(rank_due),
            rank_quiet=bool(rank_quiet), n_ranks=int(n_ranks),
            n_channels=int(n_channels), rank_of=tuple(rank_of),
            channel_of=tuple(channel_of), ranks_due=tuple(ranks_due),
            n_subarrays=int(n_subarrays),
            next_ref_sub=tuple(next_ref_sub),
            refreshing_sub=tuple(refreshing_sub),
            active_sub=tuple(active_sub))

    def apply(self, decisions: Sequence[Decision], now: float) -> list[int]:
        """Record the policy's decisions as issued; returns the flat bank
        list (rank-level `ALL_BANKS` decisions expand to every bank)."""
        banks: list[int] = []
        for d in decisions:
            targets = (range(self.n_banks) if d.bank == ALL_BANKS
                       else (d.bank,))
            for b in targets:
                self.banks[b].issued += 1
                self.banks[b].last_issue_time = now
                banks.append(b)
        return banks

    # ----------------------------------------------------------- invariant
    def check_invariant(self, now: float) -> None:
        """JEDEC budget invariant; raises on violation."""
        for b in range(self.n_banks):
            lag = self.lag(b, now)
            if not (-self.budget <= lag <= self.budget):
                raise AssertionError(
                    f"bank {b}: lag {lag} outside ±{self.budget} at t={now}")

    def snapshot_age(self, b: int, now: float) -> float:
        """Time since bank b's last maintenance (RPO metric for
        checkpoints, staleness for serving)."""
        t = self.banks[b].last_issue_time
        return now - t if t >= 0 else now
