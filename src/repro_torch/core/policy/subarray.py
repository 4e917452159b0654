"""Subarray-aware policies, added registry-only — no engine internals.

With the subarray-granular tick engines, a per-bank refresh under
the SARP trait occupies ONE subarray (`view.next_ref_sub[b]`, the
round-robin target) instead of the whole bank, and the engines expose the
mid-refresh subarray (`view.refreshing_sub[b]`) and the subarray holding
the open row (`view.active_sub[b]`). Policies in this module exploit that
plane; they import nothing but the policy protocol, so they stay
registry-only like `extras.py`.

  hira : hidden row activation — instead of seeking *idle* banks like
         DARP, prefer refreshing banks that are actively serving demand.
         The engines model the hidden start: when the refresh target
         subarray differs from the bank's active subarray
         (`next_ref_sub[b] != active_sub[b]`), the refresh command
         issues WITHOUT waiting for the in-flight access to finish —
         the row activation of the refresh is hidden behind the access,
         exactly HiRA's mechanism (arXiv:2209.10198). Only
         same-subarray requests wait; siblings keep being served at the
         `SARP_PEN` peripheral-sharing penalty.
"""
from __future__ import annotations

from repro_torch.core.policy.base import Decision, MaintenanceView, PolicyBase
from repro_torch.core.policy.registry import register_policy


@register_policy("hira")
class HiraPolicy(PolicyBase):
    """Hidden row activation (HiRA, arXiv:2209.10198).

    DARP treats a bank with demand as untouchable; HiRA observes the
    opposite opportunity: with subarray-level parallelism, a refresh issued
    to a bank that is busy serving demand hides behind the access stream —
    only same-subarray requests wait. So owed banks are taken busiest
    first, falling back to idle banks when nothing is being accessed, and
    write windows additionally pull refreshes in on busy banks.

    Not in the source paper — post-paper registry addition, motivated by
    HiRA (arXiv:2209.10198); builds on the paper's §5 SARP substrate.

    Traits: level='pb' (per-bank) · sarp=True (required — refreshing a
    busy bank only hides behind accesses with subarray-level parallelism)
    · hra=True (the tick engines start the refresh at the decision tick,
    not after the in-flight access, whenever the target subarray differs
    from the bank's active subarray — the hidden row activation)
    · write-drain: consumed (`view.write_window` triggers busy-bank
    pull-in).
    """
    sarp = True
    hra = True

    def __init__(self, name: str = "hira"):
        self.name = name

    def select(self, view: MaintenanceView) -> list[Decision]:
        lag = list(view.lag)
        picks: list[Decision] = []
        self._forced(view, lag, picks)
        if len(picks) >= view.max_issues:
            return picks
        picked = {p.bank for p in picks}
        avail = [b for b in range(view.n_banks)
                 if view.ready[b] and b not in picked]
        # owed banks: hide behind active demand first, most-demanded wins
        hot = sorted((b for b in avail if lag[b] > 0 and view.demand[b] > 0),
                     key=lambda b: (-view.demand[b], -lag[b]))
        cold = sorted((b for b in avail
                       if lag[b] > 0 and view.demand[b] == 0 and view.idle[b]),
                      key=lambda b: -lag[b])
        for b, why in ([(b, "behind access") for b in hot]
                       + [(b, "idle fallback") for b in cold]):
            if len(picks) >= view.max_issues:
                return picks
            picks.append(Decision(b, reason=why))
            lag[b] -= 1
            picked.add(b)
        if view.write_window:
            # pull in on busy banks too: the drain hides the refresh
            extra = sorted((b for b in avail
                            if b not in picked and lag[b] > -view.budget),
                           key=lambda b: (-view.demand[b], -lag[b]))
            for b in extra:
                if len(picks) >= view.max_issues:
                    break
                picks.append(Decision(b, reason="write-window pull-in"))
                lag[b] -= 1
        return picks
