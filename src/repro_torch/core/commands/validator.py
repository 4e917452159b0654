"""Streaming JEDEC sequencing validator for command traces.

Re-checks, *independently of the engines' internal state*, that an
emitted `CmdTrace` is realizable on a real controller:

* ``missing-prea``     — every REF must be preceded by its matching
                         precharge preamble (PREA for rank-level REF_AB,
                         PRE for per-bank REF_PB), litedram-style.
* ``short-trp``        — preamble -> REF gap must be >= TRP (tRP).
* ``short-trfc``       — no demand command (PRE/ACT/RD/WR) may land in an
                         active refresh footprint ``[start, start+tRFC)``
                         on the refreshing subarray(s); SARP sibling
                         subarrays stay legal.
* ``postpone-budget``  — JEDEC postpone/pull-in: at every REF the bank's
                         (or rank's) refresh lag, accounted at the
                         *decision* tick the command carries in ``data``,
                         must stay within the +/-8 budget the
                         `MaintenanceLedger` enforces.
* ``trtr-min-latency`` — tick clock only: a RD/WR's data tick must be at
                         least issue + HIT/MISS + SARP_PEN + TURN + RTR
                         per the phase-5 serve rule (tRTR rank turnaround
                         included).  Event-mode ns traces skip this rule
                         (tick-contract section 5 divergence).
* ``bad-sequence``     — structural breakage: access to a closed row
                         without a same-tick ACT, more than one serve
                         start per channel per tick, a SARP refresh
                         naming the wrong target subarray, or
                         out-of-range addressing.

The checker is a single forward pass grouping commands by timestamp, so
it streams over arbitrarily long traces with O(banks) state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.core.commands.trace import CmdTrace, _key

#: Rule identifiers, in severity-agnostic catalog order.
RULES = ("missing-prea", "short-trp", "short-trfc", "postpone-budget",
         "trtr-min-latency", "bad-sequence")


@dataclass(frozen=True)
class Violation:
    rule: str      # one of RULES
    tick: float    # timestamp of the offending command (-1 = trace-level)
    index: int     # position in the canonical command order (-1 = trace-level)
    addr: str      # "ch0.r1.b3.s2"-style locator ("" when not addressable)
    detail: str    # human-readable specifics

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        return (f"[{self.rule}] t={self.tick} #{self.index} {self.addr}: "
                f"{self.detail}")


def _addr(ch, rank, bank, sub) -> str:
    out = f"ch{ch}.r{rank}"
    if bank >= 0:
        out += f".b{bank}"
    if sub >= 0:
        out += f".s{sub}"
    return out


class _Footprint:
    """An in-flight refresh window ``[start, end)`` on one bank.

    ``sub == -1`` covers the whole bank (non-SARP refresh); otherwise
    only the named subarray is busy and SARP sibling serves stay legal.
    """

    __slots__ = ("start", "end", "gb", "sub")

    def __init__(self, start, end, gb, sub):
        self.start, self.end, self.gb, self.sub = start, end, gb, sub

    def covers(self, gb, sub) -> bool:
        return self.gb == gb and (self.sub == -1 or sub == -1
                                  or self.sub == sub)


def validate_trace(trace: CmdTrace, *, limit: int = 64) -> List[Violation]:
    """Run every rule over ``trace``; return at most ``limit`` violations.

    An empty list means the trace is sequencing-clean.  The trace's
    ``meta`` supplies hierarchy, policy traits, and the `TIMING_FIELDS`
    constants; commands are re-sorted into canonical order first so
    externally-assembled traces need not be pre-sorted.
    """
    m = trace.meta
    tick_clock = m.get("clock", "tick") == "tick"
    NB = int(m["n_banks"])
    NR = int(m["n_ranks"])
    NC = int(m["n_channels"])
    S = int(m["n_subarrays"])
    R = NR * NC
    B = R * NB
    REFI = m["REFI"]
    REFI_PB = m["REFI_PB"]
    RFC = {"REF_AB": m["RFC_AB"], "REF_PB": m["RFC_PB"]}
    TRP = m["TRP"]
    BUDGET = int(m["BUDGET"])
    sarp = bool(m.get("sarp", False))
    ideal = bool(m.get("ideal", False))
    level = m.get("level", "pb")
    HIT, MISS = m["HIT"], m["MISS"]
    TURN, RTR, SARP_PEN = m["TURN"], m["RTR"], m["SARP_PEN"]

    cmds = sorted(trace.cmds, key=_key)
    out: List[Violation] = []

    def emit(rule, tick, idx, addr, detail):
        if len(out) < limit:
            out.append(Violation(rule, tick, idx, addr, detail))

    # --- per-bank / per-rank state -------------------------------------
    open_row = [[-1] * S for _ in range(B)]
    ctr = [0] * B                     # refresh-target rotation (ctr % S)
    issued_pb = [0] * B
    issued_ab = [0] * R
    # phase offsets match the engines: per-bank pb staggering and
    # per-rank ab staggering (tick-contract sections 3 and 4).
    phase = [b * REFI_PB for b in range(B)]
    if tick_clock:
        rank_phase = [gr * (REFI // R) for gr in range(R)]
    else:
        rank_phase = [gr * (REFI / R) for gr in range(R)]
    pend_pre = {}        # (gb, sub) -> (tick, index) awaiting REF_PB
    pend_prea = {}       # gr -> (tick, index) awaiting REF_AB
    foots: List[_Footprint] = []
    last_op = [False] * NC
    last_rank = [-1] * NC

    def due_pb(b, t):
        if t < phase[b]:
            return 0
        return int((t - phase[b]) // REFI) + 1

    def acc_ab(gr, t):
        d = t - rank_phase[gr]
        return int(d // REFI) if d > 0 else 0

    def foot_hit(gb, sub):
        for f in foots:
            if f.covers(gb, sub):
                return f
        return None

    def bank_busy(gb):
        return any(f.gb == gb for f in foots)

    def start_footprint(start, op, gb, sub):
        end = start + RFC[op]
        prev = foot_hit(gb, sub)
        foots.append(_Footprint(start, end, gb, sub))
        # close the covered row(s): refresh begins with a precharge
        if sub == -1:
            open_row[gb] = [-1] * S
        else:
            open_row[gb][sub] = -1
        return prev

    n = len(cmds)
    i = 0
    while i < n:
        t = cmds[i].tick
        j = i
        while j < n and cmds[j].tick == t:
            j += 1
        group = cmds[i:j]

        foots[:] = [f for f in foots if f.end > t]
        acts = set()
        served = [0] * NC
        for c in group:
            if c.op == "ACT":
                gb = (c.ch * NR + c.rank) * NB + c.bank
                acts.add((gb, c.sub))

        for k, c in enumerate(group):
            idx = i + k
            ch, rank, bank, sub = c.ch, c.rank, c.bank, c.sub
            addr = _addr(ch, rank, bank, sub)
            rank_level = c.op in ("PREA", "REF_AB")
            if (not 0 <= ch < NC or not 0 <= rank < NR
                    or not 0 <= sub < S and sub != -1
                    or (rank_level and bank != -1)
                    or (not rank_level and not 0 <= bank < NB)):
                emit("bad-sequence", t, idx, addr,
                     f"{c.op} addressing out of range for "
                     f"hierarchy C{NC}xR{NR}xB{NB}xS{S}")
                continue
            gr = ch * NR + rank
            gb = gr * NB + bank if bank >= 0 else -1

            if c.op == "PREA":
                # rank-level preamble: the whole rank's footprint opens
                # at the decision tick (engines set ref_until here), so
                # demand landing before the REF_AB itself is also caught
                pend_prea[gr] = (t, idx)
                for b in range(gr * NB, (gr + 1) * NB):
                    tsub = ctr[b] % S if sarp else -1
                    start_footprint(t, "REF_AB", b, tsub)

            elif c.op == "PRE":
                if (gb, sub) in acts or (gb, -1) in acts:
                    # demand precharge (same-tick ACT follows): only
                    # legal outside any active refresh footprint
                    f = foot_hit(gb, sub)
                    if f is not None:
                        emit("short-trfc", t, idx, addr,
                             f"demand PRE inside refresh footprint "
                             f"[{f.start}, {f.end})")
                    if sub >= 0:
                        open_row[gb][sub] = -1
                else:
                    # refresh preamble: opens a provisional footprint
                    pend_pre[(gb, sub)] = (t, idx)
                    start_footprint(t, "REF_PB", gb, sub)

            elif c.op == "ACT":
                f = foot_hit(gb, sub)
                if f is not None:
                    emit("short-trfc", t, idx, addr,
                         f"ACT inside refresh footprint "
                         f"[{f.start}, {f.end})")
                if sub >= 0:
                    open_row[gb][sub] = c.row

            elif c.op == "REF_PB":
                pre = pend_pre.pop((gb, sub), None)
                if pre is None:
                    emit("missing-prea", t, idx, addr,
                         "REF_PB without a preceding PRE preamble")
                    start_footprint(t, "REF_PB", gb, sub)
                else:
                    gap = t - pre[0]
                    if gap < TRP:
                        emit("short-trp", t, idx, addr,
                             f"PRE->REF_PB gap {gap} < TRP {TRP}")
                if sarp and sub != ctr[gb] % S:
                    emit("bad-sequence", t, idx, addr,
                         f"SARP REF_PB targets s{sub}, rotation expects "
                         f"s{ctr[gb] % S}")
                ctr[gb] += 1
                issued_pb[gb] += 1
                if level == "pb" and not ideal:
                    td = c.data if c.data >= 0 else t - TRP
                    lag = due_pb(gb, td) - issued_pb[gb]
                    if abs(lag) > BUDGET:
                        emit("postpone-budget", t, idx, addr,
                             f"per-bank refresh lag {lag} at decision "
                             f"tick {td} exceeds +/-{BUDGET}")

            elif c.op == "REF_AB":
                pre = pend_prea.pop(gr, None)
                if pre is None:
                    emit("missing-prea", t, idx, addr,
                         "REF_AB without a preceding PREA preamble")
                    for b in range(gr * NB, (gr + 1) * NB):
                        tsub = ctr[b] % S if sarp else -1
                        start_footprint(t, "REF_AB", b, tsub)
                else:
                    gap = t - pre[0]
                    if gap < TRP:
                        emit("short-trp", t, idx, addr,
                             f"PREA->REF_AB gap {gap} < TRP {TRP}")
                if sarp:
                    for b in range(gr * NB, (gr + 1) * NB):
                        ctr[b] += 1
                issued_ab[gr] += 1
                if level == "ab" and not ideal:
                    td = c.data if c.data >= 0 else t - TRP
                    acc = acc_ab(gr, td)
                    if issued_ab[gr] > acc:
                        emit("postpone-budget", t, idx, addr,
                             f"rank REF_AB #{issued_ab[gr]} pulled in "
                             f"before accrual {acc} at tick {td}")
                    elif acc - issued_ab[gr] > BUDGET:
                        emit("postpone-budget", t, idx, addr,
                             f"rank refresh lag {acc - issued_ab[gr]} at "
                             f"decision tick {td} exceeds {BUDGET}")

            elif c.op in ("RD", "WR"):
                isw = c.op == "WR"
                f = foot_hit(gb, sub)
                if f is not None:
                    emit("short-trfc", t, idx, addr,
                         f"{c.op} inside refresh footprint "
                         f"[{f.start}, {f.end})")
                if tick_clock:
                    served[ch] += 1
                    if served[ch] > 1:
                        emit("bad-sequence", t, idx, addr,
                             "more than one serve start on the channel "
                             "in one tick")
                miss = (gb, sub) in acts
                if not miss and sub >= 0 and open_row[gb][sub] != c.row:
                    emit("bad-sequence", t, idx, addr,
                         f"{c.op} row {c.row} but open row is "
                         f"{open_row[gb][sub]} and no same-tick ACT")
                if tick_clock:
                    exp = MISS if miss else HIT
                    terms = ["MISS" if miss else "HIT"]
                    if sarp and bank_busy(gb):
                        exp += SARP_PEN
                        terms.append("SARP_PEN")
                    if isw != last_op[ch]:
                        exp += TURN
                        terms.append("TURN")
                    if 0 <= last_rank[ch] != gr:
                        exp += RTR
                        terms.append("RTR")
                    if c.data - t < exp:
                        emit("trtr-min-latency", t, idx, addr,
                             f"{c.op} data at +{c.data - t} < minimum "
                             f"{exp} ({'+'.join(terms)})")
                    last_op[ch] = isw
                    last_rank[ch] = gr
            else:
                emit("bad-sequence", t, idx, addr,
                     f"unknown mnemonic {c.op!r}")
        i = j

    # --- trace-level closure: no bank may end starved beyond the budget
    end = m.get("end")
    if end is None and cmds:
        end = cmds[-1].tick
    if end is not None and not ideal:
        if level == "pb":
            for b in range(B):
                lag = due_pb(b, end) - issued_pb[b]
                if lag > BUDGET:
                    emit("postpone-budget", end, -1,
                         _addr(b // NB // NR, (b // NB) % NR, b % NB, -1),
                         f"bank ends the trace {lag} refreshes behind "
                         f"(budget {BUDGET})")
        elif level == "ab":
            for gr in range(R):
                lag = acc_ab(gr, end) - issued_ab[gr]
                if lag > BUDGET:
                    emit("postpone-budget", end, -1,
                         _addr(gr // NR, gr % NR, -1, -1),
                         f"rank ends the trace {lag} refreshes behind "
                         f"(budget {BUDGET})")
    return out
