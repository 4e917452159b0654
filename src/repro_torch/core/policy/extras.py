"""Post-paper policies, added registry-only — no engine internals touched.

These exist to prove the `RefreshPolicy` API earns its keep: they run
end-to-end through the DRAM density sweep (`run_policy("elastic", ...)`)
and the serving benchmark purely by being registered here.

  elastic : demand-elastic postpone — refresh debt is deferred while demand
            pressure is high and repaid aggressively (with pull-in) in
            low-pressure valleys, with a smoothing ramp so the forced cliff
            at the budget edge is never hit all at once. Inspired by the
            refresh-access parallelism follow-on work (arXiv:1805.01289).

The subarray-aware `hira` policy, which used to live here, moved to
`repro_torch.core.policy.subarray` when the tick engines grew a real
subarray plane for it to exploit.
"""
from __future__ import annotations

from repro_torch.core.policy.base import Decision, MaintenanceView, PolicyBase
from repro_torch.core.policy.registry import register_policy


@register_policy("elastic")
class ElasticPolicy(PolicyBase):
    """Demand-elastic postpone/pull-in.

    Three pressure regimes, measured as total pending demand across banks:
      quiet    (== 0)          : repay and pre-pay — refresh every available
                                 bank, most-owed first, pulling in down to
                                 -budget so future busy phases start with
                                 headroom,
      moderate (<= n_banks)    : DARP-like — only owed, idle, zero-demand
                                 banks,
      high     (> n_banks)     : postpone everything except banks whose lag
                                 has climbed past `urgency * budget`; those
                                 are refreshed even if busy, smoothing what
                                 would otherwise become a forced stall at a
                                 worse time.
    The ±budget invariant is kept by the shared forced path (upper edge)
    and the `lag > -budget` pull-in floor (lower edge).

    SLO awareness: when the engine reports `view.slo_pressure` at or
    above `slo_defer` (a serving engine with many requests out of
    TTFT/TPOT headroom), the policy drops into the high-pressure
    postpone regime regardless of raw demand — refreshes are deferred
    until the deadline wave passes, except for banks riding the budget
    edge. Engines that leave `slo_pressure` at 0.0 (every tick engine)
    see bit-identical behavior to the pre-SLO policy.

    Not in the source paper — post-paper registry addition, motivated by
    the refresh-access parallelism follow-up (arXiv:1805.01289).

    Traits: level='pb' (per-bank) · sarp=False by default · write-drain:
    ignored (pressure regimes come from `view.demand` instead).
    """

    def __init__(self, name: str = "elastic", sarp: bool = False,
                 urgency: float = 0.75, slo_defer: float = 0.5):
        assert 0.0 < urgency <= 1.0
        assert 0.0 < slo_defer <= 1.0
        self.name = name
        self.sarp = sarp
        self.urgency = urgency
        self.slo_defer = slo_defer

    def select(self, view: MaintenanceView) -> list[Decision]:
        lag = list(view.lag)
        picks: list[Decision] = []
        self._forced(view, lag, picks)
        if len(picks) >= view.max_issues:
            return picks
        picked = {p.bank for p in picks}
        pressure = sum(view.demand)
        urgent_at = max(1, int(self.urgency * view.budget))

        def take(cands, reason):
            for b in cands:
                if len(picks) >= view.max_issues:
                    break
                picks.append(Decision(b, reason=reason))
                lag[b] -= 1
                picked.add(b)

        if view.slo_pressure >= self.slo_defer:
            # deadline wave: postpone like the high-pressure regime, but
            # still ramp into the budget edge so the forced cliff never
            # lands mid-wave (slo_pressure == 0 never reaches here)
            cands = sorted((b for b in range(view.n_banks)
                            if view.ready[b] and b not in picked
                            and lag[b] >= urgent_at),
                           key=lambda b: -lag[b])
            take(cands, "slo-deadline defer")
        elif pressure == 0:
            # quiet valley: repay owed refreshes and pre-pay future ones
            cands = sorted((b for b in range(view.n_banks)
                            if view.ready[b] and view.idle[b]
                            and b not in picked and lag[b] > -view.budget),
                           key=lambda b: -lag[b])
            take(cands, "quiet-valley repay")
        elif pressure <= view.n_banks:
            cands = sorted((b for b in range(view.n_banks)
                            if view.ready[b] and view.idle[b]
                            and b not in picked
                            and view.demand[b] == 0 and lag[b] > 0),
                           key=lambda b: -lag[b])
            take(cands, "moderate-pressure idle refresh")
        else:
            # high pressure: postpone, but ramp into the budget edge early
            cands = sorted((b for b in range(view.n_banks)
                            if view.ready[b] and b not in picked
                            and lag[b] >= urgent_at),
                           key=lambda b: -lag[b])
            take(cands, "urgency ramp")
        return picks
