"""Generic maintenance scheduling over framework "banks" — a compatibility
wrapper around `MaintenanceLedger` + the shared `repro_torch.core.policy` objects.

A *bank* is any resource that needs periodic maintenance:
  * training   : a parameter/optimizer shard whose checkpoint snapshot must
                 be flushed every `interval` steps,
  * serving    : a KV-cache page-group whose staged bf16 pages must be
                 compressed (re-quantized) every `interval` decode rounds.

Both halves of the job live elsewhere and are shared with every other
engine in the repo:

  * the decision logic is the registered `repro_torch.core.policy` objects —
    the same code the timing-accurate `DramSim` runs,
  * the due/issued bookkeeping and `MaintenanceView` construction is
    `repro_torch.core.policy.ledger.MaintenanceLedger` — the same object the
    serving `EngineCore` drives directly (its hot path does not go
    through this class).

This wrapper only glues the two together behind the historical
`select(now, demand=...) -> [bank]` call shape, for callers that predate
the ledger (checkpoint engine, existing tests, notebooks):

    DarpScheduler(n_banks=8, interval=4.0, policy="hira")

`SchedulerPolicy` remains as a legacy enum shim for the four historical
framework spellings; its members resolve through the same registry.

The JEDEC-style postpone/pull-in budget is the data-integrity guarantee:
for every bank, at all times, -budget <= due(now) - issued <= budget, with
forced maintenance when the postpone budget is exhausted.
"""
from __future__ import annotations

import enum
from typing import Optional, Sequence, Union

from repro_torch.core.policy import (MaintenanceLedger, RefreshPolicy,
                               resolve_policy)
from repro_torch.core.policy.ledger import BankLedgerState as BankState  # noqa: F401
# (re-exported: `BankState` was defined here before the ledger existed)


class SchedulerPolicy(str, enum.Enum):
    """Legacy spellings; each value is a `repro_torch.core.policy` registry name."""
    ALL_BANK = "all_bank"        # stop-the-world maintenance (REF_ab analogue)
    ROUND_ROBIN = "round_robin"  # strict in-order per-bank (REF_pb analogue)
    DARP_OOO = "darp_ooo"        # out-of-order only
    DARP = "darp"                # out-of-order + write-window parallelization


class DarpScheduler:
    """Decide *which* banks get maintenance *now*. Time is caller-defined
    (steps, rounds, seconds) and strictly non-decreasing across calls."""

    def __init__(self, n_banks: int, interval: float, *,
                 budget: int = 8,
                 policy: Union[str, SchedulerPolicy, RefreshPolicy] = "darp",
                 stagger: bool = True):
        self.ledger = MaintenanceLedger(n_banks, interval, budget=budget,
                                        stagger=stagger)
        self.policy: RefreshPolicy = resolve_policy(policy)

    # ---------------------------------------------------- ledger passthrough
    @property
    def n_banks(self) -> int:
        return self.ledger.n_banks

    @property
    def interval(self) -> float:
        return self.ledger.interval

    @property
    def budget(self) -> int:
        return self.ledger.budget

    @property
    def banks(self) -> list:
        return self.ledger.banks

    @property
    def phase(self) -> list:
        return self.ledger.phase

    def due(self, b: int, now: float) -> int:
        return self.ledger.due(b, now)

    def lag(self, b: int, now: float) -> int:
        """due - issued; >0 means owed, <0 means pulled in."""
        return self.ledger.lag(b, now)

    def overdue(self, now: float) -> list[int]:
        return self.ledger.overdue(now)

    # -------------------------------------------------------------- select
    def select(self, now: float, *, demand: Sequence[int],
               write_window: bool = False, max_issues: int = 1,
               ready: Optional[Sequence[bool]] = None,
               idle: Optional[Sequence[bool]] = None) -> list[int]:
        """Pick up to `max_issues` banks to maintain at `now`.

        demand[b]: pending demand work on bank b (queue depth). The caller
        MUST perform the maintenance for every returned bank (they are
        recorded as issued). `ready`/`idle` default to all-True — generic
        engines can always start maintenance; the timing simulator passes
        real occupancy masks.
        """
        view = self.ledger.view(now, demand=demand,
                                write_window=write_window,
                                max_issues=max_issues, ready=ready, idle=idle)
        return self.ledger.apply(self.policy.select(view), now)

    # ------------------------------------------------------------ invariant
    def check_invariant(self, now: float) -> None:
        """JEDEC budget invariant; raises on violation."""
        self.ledger.check_invariant(now)

    def snapshot_age(self, b: int, now: float) -> float:
        """Time since bank b's last maintenance (RPO metric for checkpoints)."""
        return self.ledger.snapshot_age(b, now)
