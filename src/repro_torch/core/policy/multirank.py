"""Hierarchy-aware registry policies: refresh scheduling that only makes
sense once the DRAM model exposes the [channel, rank, bank] hierarchy
(`MaintenanceView.rank_of` / `channel_of` / `ranks_due`).

  staggered_ab    : round-robin all-bank refresh across ranks. Commodity
                    controllers stagger REF_ab so only one rank per
                    channel is ever draining — the other ranks keep
                    serving, which is what makes all-bank refresh
                    tolerable at all (see e.g. the per-rank refresh
                    timers of real LPDDR4 controllers). Never issues
                    overlapping all-bank refreshes on the same channel.
  rank_aware_darp : DARP whose out-of-order/pull-in candidate order
                    prefers banks on ranks whose bus slots are idle (no
                    pending demand anywhere on the rank) — the refresh
                    hides behind traffic to *other* ranks of the channel.
                    At one rank every candidate shares the rank, the
                    preference is a constant, and the policy degrades to
                    plain `darp` bit-for-bit (pinned by
                    tests/test_multirank.py).

Both fall back to their flat-view ancestors on generic engines (serving,
checkpoint), where the view carries no hierarchy.
"""
from __future__ import annotations

from repro_torch.core.policy.base import (ALL_BANKS, Decision, MaintenanceView,
                                    PolicyBase)
from repro_torch.core.policy.paper import AllBankPolicy, DarpPolicy
from repro_torch.core.policy.registry import register_policy


@register_policy("staggered_ab")
class StaggeredAllBankPolicy(AllBankPolicy):
    """Round-robin REF_ab across ranks, one rank at a time per channel.

    A strict round-robin pointer walks the global ranks; the pointed-at
    rank starts its all-bank refresh only when (a) it has pending debt,
    (b) its own banks are quiet (ready + idle), and (c) no bank anywhere
    on its channel is mid-refresh — so two ranks of one channel never
    drain at once. The pointer advances only on issue, matching the
    per-rank debt-accrual stagger (rank r's debt lands tREFI/R after
    rank r-1's), so in steady state the pointer and the debt rotate
    together.

    Traits: level='ab' (rank-level) · sarp=False · write-drain: ignored ·
    stateful (rank round-robin pointer; one instance per engine run).
    With one rank (or on a generic engine's flat view) it behaves exactly
    like "ref_ab".
    """
    level = "ab"

    def __init__(self, name: str = "staggered_ab", sarp: bool = False):
        super().__init__(name=name, sarp=sarp)
        self._rr = 0

    def select(self, view: MaintenanceView) -> list[Decision]:
        if not view.ranks_due:           # generic engines: flat REF_ab
            return AllBankPolicy.select(self, view)
        R = view.n_ranks_total
        gr = self._rr % R
        if (view.ranks_due[gr] > 0 and view.rank_is_quiet(gr)
                and view.channel_is_clear(gr // view.n_ranks)):
            self._rr += 1
            return [Decision(ALL_BANKS, rank=gr,
                             reason="staggered rank refresh")]
        return []


@register_policy("rank_aware_darp")
class RankAwareDarpPolicy(DarpPolicy):
    """DARP that prefers refreshing banks on demand-idle ranks.

    Same structure as `DarpPolicy` (forced sweep, then either the
    write-window pull-in branch or the idle out-of-order branch over
    ready+idle zero-demand banks); only the candidate *order* changes:
    banks whose whole rank has zero pending demand come first (their
    channel bus slots are idle, so the refresh steals no transfer), then
    most-owed, then lowest bank index. With one rank the rank-idle key is
    constant across candidates and the order — hence every decision — is
    identical to `darp`.

    Traits: level='pb' · wrp=True · sarp per registration · write-drain:
    consumed (pull-in branch, like darp).
    """

    def __init__(self, name: str = "rank_aware_darp", wrp: bool = True,
                 sarp: bool = False):
        super().__init__(name=name, wrp=wrp, sarp=sarp)

    def _rank_busy(self, view: MaintenanceView) -> list[bool]:
        """Per-bank: does the bank's rank have ANY pending demand?"""
        if not view.rank_of:
            busy = sum(view.demand) > 0
            return [busy] * view.n_banks
        rank_demand: dict[int, int] = {}
        for b in range(view.n_banks):
            gr = view.rank_of[b]
            rank_demand[gr] = rank_demand.get(gr, 0) + view.demand[b]
        return [rank_demand[view.rank_of[b]] > 0
                for b in range(view.n_banks)]

    def select(self, view: MaintenanceView) -> list[Decision]:
        lag = list(view.lag)
        picks: list[Decision] = []
        self._forced(view, lag, picks)
        if len(picks) >= view.max_issues:
            return picks
        picked = {p.bank for p in picks}
        rank_busy = self._rank_busy(view)
        avail = [b for b in range(view.n_banks)
                 if view.ready[b] and view.idle[b] and b not in picked]
        if self.wrp and view.write_window:
            cands = sorted((b for b in avail
                            if view.demand[b] == 0 and lag[b] > -view.budget),
                           key=lambda b: (rank_busy[b], -lag[b]))
            for b in cands:
                if len(picks) >= view.max_issues:
                    break
                picks.append(Decision(b, reason="rank-idle pull-in"))
                lag[b] -= 1
            return picks
        cands = sorted((b for b in avail
                        if view.demand[b] == 0 and lag[b] > 0),
                       key=lambda b: (rank_busy[b], -lag[b]))
        for b in cands:
            if len(picks) >= view.max_issues:
                break
            picks.append(Decision(b, reason="rank-idle out-of-order"))
            lag[b] -= 1
        return picks
