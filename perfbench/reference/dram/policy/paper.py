"""The paper's refresh-policy family, implemented once against the
`RefreshPolicy` protocol (HPCA-14 "Reducing Performance Impact of DRAM
Refresh by Parallelizing Refreshes with Accesses").

Registered names (timing-sim spellings and framework aliases both resolve
here — the decision logic exists ONLY in this module):

  ideal              : no refresh (upper bound)
  ref_ab / all_bank  : all-bank refresh (DDR REF_ab; stop-the-world)
  ref_pb / round_robin : per-bank refresh, strict round-robin (LPDDR REF_pb)
  darp_ooo           : DARP component 1 — out-of-order idle-first refresh
  darp               : + component 2 — write-refresh parallelization (WRP)
  sarp_ab            : SARP on top of all-bank refresh
  sarp_pb            : SARP on top of per-bank round-robin
  dsarp              : DARP + SARP (the paper's final mechanism)

SARP is a *trait* (`sarp=True`), not a selection algorithm: the timing
simulator models per-subarray availability during a refresh, so SARP
variants reuse the ab/pb/DARP selection logic unchanged.
"""
from __future__ import annotations

from perfbench.reference.dram.policy.base import (ALL_BANKS, Decision, MaintenanceView,
                                    PolicyBase)
from perfbench.reference.dram.policy.registry import register_policy


@register_policy("ideal")
class IdealPolicy(PolicyBase):
    """No refresh at all — the paper's upper-bound baseline (the "ideal"
    bar of Figures 1/3; §7 evaluation).

    Traits: ideal=True (engines skip select() entirely) · level='pb'
    (unused) · sarp=False · write-drain: ignored.
    """
    ideal = True

    def __init__(self, name: str = "ideal"):
        self.name = name

    def select(self, view: MaintenanceView) -> list[Decision]:
        return []


class AllBankPolicy(PolicyBase):
    """REF_ab: stop-the-world maintenance (paper §2, the DDR3 all-bank
    refresh baseline; registered as "ref_ab"/"all_bank", and "sarp_ab"
    for the §5 SARP-on-REF_ab variant).

    Timing simulator (`view.ranks_due` / `view.rank_due` set): each due
    rank drains, then one tRFC_ab-long refresh covers every bank of that
    rank. Hierarchy-aware engines set `ranks_due` per global rank and get
    one `Decision(ALL_BANKS, rank=gr)` for every rank that is due and
    quiet — with one rank this is exactly the legacy single-rank
    stop-the-world behavior. Generic engines (rank_due==0): when anything
    is owed, sweep EVERY owed bank in one call — max_issues deliberately
    does not apply; that is the point of REF_ab.

    Traits: level='ab' (rank-level) · sarp per registration (False for
    "ref_ab"/"all_bank", True for "sarp_ab") · write-drain: ignored.
    """
    level = "ab"

    def __init__(self, name: str = "ref_ab", sarp: bool = False):
        self.name = name
        self.sarp = sarp

    def select(self, view: MaintenanceView) -> list[Decision]:
        if view.ranks_due:               # hierarchy-aware tick engines
            return [Decision(ALL_BANKS, rank=gr, reason="rank refresh")
                    for gr in range(view.n_ranks_total)
                    if view.ranks_due[gr] > 0 and view.rank_is_quiet(gr)]
        if view.rank_due > 0:            # legacy single-rank spelling
            if view.rank_quiet:
                return [Decision(ALL_BANKS, reason="rank refresh")]
            return []
        lag = list(view.lag)
        picks: list[Decision] = []
        self._forced(view, lag, picks)
        if any(l > 0 for l in lag):
            picked = {p.bank for p in picks}
            for b in range(view.n_banks):
                if lag[b] > 0 and b not in picked:
                    picks.append(Decision(b, reason="stop-the-world sweep"))
                    lag[b] -= 1
        return picks


class RoundRobinPolicy(PolicyBase):
    """REF_pb: strict in-order per-bank refresh (paper §3, the LPDDR
    per-bank baseline; registered as "ref_pb"/"round_robin", and
    "sarp_pb" for the §5 SARP-on-REF_pb variant).

    The due bank is maintained at its scheduled time regardless of pending
    demand — the refresh begins the moment the bank is free of refreshes,
    queueing behind any in-flight access.

    Traits: level='pb' (per-bank) · sarp per registration (False for
    "ref_pb"/"round_robin", True for "sarp_pb") · write-drain: ignored ·
    stateful (round-robin pointer; one instance per engine run).
    """

    def __init__(self, name: str = "ref_pb", sarp: bool = False):
        self.name = name
        self.sarp = sarp
        self._rr = 0

    def select(self, view: MaintenanceView) -> list[Decision]:
        lag = list(view.lag)
        picks: list[Decision] = []
        self._forced(view, lag, picks)
        while len(picks) < view.max_issues:
            b = self._rr % view.n_banks
            if lag[b] > 0 and view.ready[b]:
                picks.append(Decision(b, reason="round robin"))
                lag[b] -= 1
                self._rr += 1
            else:
                break
        return picks


class DarpPolicy(PolicyBase):
    """DARP: out-of-order refresh + optional write-refresh
    parallelization (paper §4; registered as "darp_ooo" = §4.2 component
    alone, "darp" = §4.2 + §4.3, "dsarp" = DARP with the §5 SARP trait,
    i.e. the paper's final §6 mechanism).

    Component 1 (always on; §4.2 out-of-order per-bank refresh): refresh
    an *idle* bank with no pending demand instead of the round-robin one —
    most-owed first, and only banks that actually owe a refresh (lag > 0).

    Component 2 (`wrp=True`; §4.3 write-refresh parallelization, active
    during write windows): hide refreshes under the write drain by pulling
    maintenance in (down to -budget) on banks with no demand of their own
    — refreshing a bank that still holds batch writes would lengthen the
    drain instead.

    Traits: level='pb' (per-bank) · wrp per registration (False for
    "darp_ooo") · sarp per registration (True for "dsarp") · write-drain:
    consumed when wrp=True (`view.write_window` triggers pull-in).
    """

    def __init__(self, name: str = "darp", wrp: bool = True,
                 sarp: bool = False):
        self.name = name
        self.wrp = wrp
        self.sarp = sarp

    def select(self, view: MaintenanceView) -> list[Decision]:
        lag = list(view.lag)
        picks: list[Decision] = []
        self._forced(view, lag, picks)
        if len(picks) >= view.max_issues:
            return picks
        picked = {p.bank for p in picks}
        avail = [b for b in range(view.n_banks)
                 if view.ready[b] and view.idle[b] and b not in picked]
        if self.wrp and view.write_window:
            cands = sorted((b for b in avail
                            if view.demand[b] == 0 and lag[b] > -view.budget),
                           key=lambda b: -lag[b])
            for b in cands:
                if len(picks) >= view.max_issues:
                    break
                picks.append(Decision(b, reason="write-window pull-in"))
                lag[b] -= 1
            return picks
        cands = sorted((b for b in avail
                        if view.demand[b] == 0 and lag[b] > 0),
                       key=lambda b: -lag[b])
        for b in cands:
            if len(picks) >= view.max_issues:
                break
            picks.append(Decision(b, reason="idle out-of-order"))
            lag[b] -= 1
        return picks


# ---- registry spellings -------------------------------------------------
# Timing-sim names and framework aliases map onto the SAME classes; SARP
# variants differ only by trait.
register_policy("ref_ab", AllBankPolicy)
register_policy("all_bank", lambda **kw: AllBankPolicy(name="all_bank", **kw))
register_policy("sarp_ab",
                lambda **kw: AllBankPolicy(name="sarp_ab", sarp=True, **kw))
register_policy("ref_pb", RoundRobinPolicy)
register_policy("round_robin",
                lambda **kw: RoundRobinPolicy(name="round_robin", **kw))
register_policy("sarp_pb",
                lambda **kw: RoundRobinPolicy(name="sarp_pb", sarp=True, **kw))
register_policy("darp", DarpPolicy)
register_policy("darp_ooo",
                lambda **kw: DarpPolicy(name="darp_ooo", wrp=False, **kw))
register_policy("dsarp",
                lambda **kw: DarpPolicy(name="dsarp", sarp=True, **kw))
