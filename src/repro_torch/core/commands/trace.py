"""DFI-style DRAM command records and trace emission.

The normative catalog lives in docs/tick-contract.md section 7; the
`commands` analysis pass (CM601/CM602) pins `MNEMONICS` and
`TIMING_FIELDS` below to that table, mirroring the bitfield pass.

A `Cmd` is one timestamped controller command with full
channel/rank/bank/subarray addressing.  Timestamps are integer ticks
for `run_ticks`/sweep traces (`meta["clock"] == "tick"`) and float
nanoseconds for event-mode `run()` traces (`meta["clock"] == "ns"`) —
the two clocks are *named different things* on purpose (tick-contract
section 5) and the validator only applies the minimum-latency rule to
tick traces.

`data` semantics per op:

* ``RD``/``WR``      — tick the data burst completes (serve latency end),
* ``REF_AB``/``REF_PB`` — the *decision* tick (phase 4 / refresher grant),
  which is what the postpone/pull-in budget is accounted against; the
  command's own timestamp is the decision tick plus ``TRP``,
* everything else  — ``-1``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

#: Normative command mnemonics (docs/tick-contract.md section 7).
MNEMONICS = ("ACT", "PRE", "PREA", "RD", "WR", "REF_AB", "REF_PB")

#: Normative timing/config fields carried in every trace's ``meta`` —
#: the quantized `TickTiming`-style constants the validator re-derives
#: its windows from (ns traces carry the same keys with raw-ns values).
TIMING_FIELDS = ("REFI", "REFI_PB", "RFC_AB", "RFC_PB", "TRP", "HIT",
                 "MISS", "WR", "TURN", "RTR", "SARP_PEN", "BUDGET")

# Canonical intra-tick order: decisions (precharges/refreshes) precede
# serves, matching the per-tick phase order (phases 3-4 before phase 5).
_OP_ORDER = {"PREA": 0, "PRE": 1, "ACT": 2, "REF_AB": 3, "REF_PB": 4,
             "RD": 5, "WR": 6}


class Cmd(NamedTuple):
    """One DFI-style command record (``-1`` = not applicable)."""

    tick: float     # int ticks (clock == "tick") or float ns (clock == "ns")
    op: str         # one of MNEMONICS
    ch: int         # channel
    rank: int       # rank within channel (-1 never; PREA/REF_AB are rank-level)
    bank: int       # bank within rank; -1 for rank-level ops (PREA, REF_AB)
    sub: int        # target subarray; -1 = whole bank (non-SARP refresh, etc.)
    row: int        # row address for ACT/RD/WR (and the row being closed by PRE)
    data: float     # see module docstring


def _key(c: Cmd):
    return (c.tick, _OP_ORDER.get(c.op, 99), c.ch, c.rank, c.bank, c.sub,
            c.row, c.data)


@dataclass
class CmdTrace:
    """A canonically-ordered command trace plus its provenance.

    ``meta`` carries the hierarchy (n_banks/n_ranks/n_channels/
    n_subarrays), the policy traits the validator needs (level, sarp,
    hra, ideal), the clock, and every `TIMING_FIELDS` constant.
    ``demand`` (tick traces only) optionally carries the raw per-core
    request streams so `repro_torch.core.commands.replay` can re-drive the
    originating run bit-identically.
    """

    meta: dict
    cmds: List[Cmd] = field(default_factory=list)
    demand: Optional[dict] = None

    def __len__(self) -> int:
        return len(self.cmds)

    def counts(self) -> dict:
        out = {op: 0 for op in MNEMONICS}
        for c in self.cmds:
            out[c.op] = out.get(c.op, 0) + 1
        return out

    def to_json(self) -> dict:
        out = {"meta": dict(self.meta), "cmds": [list(c) for c in self.cmds]}
        if self.demand is not None:
            streams = []
            for s in self.demand["streams"]:
                streams.append({
                    "is_write": [bool(v) for v in s["is_write"]],
                    "bank": [int(v) for v in s["bank"]],
                    "row": [int(v) for v in s["row"]],
                    "subarray": [int(v) for v in s["subarray"]],
                    "think": [float(v) for v in s["think"]],
                })
            out["demand"] = {"mlp": int(self.demand["mlp"]),
                            "streams": streams}
        else:
            out["demand"] = None
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "CmdTrace":
        cmds = sorted((Cmd(*row) for row in obj["cmds"]), key=_key)
        demand = None
        if obj.get("demand") is not None:
            import numpy as np
            streams = []
            for s in obj["demand"]["streams"]:
                streams.append({
                    "is_write": np.asarray(s["is_write"], dtype=bool),
                    "bank": np.asarray(s["bank"], dtype=np.int64),
                    "row": np.asarray(s["row"], dtype=np.int64),
                    "subarray": np.asarray(s["subarray"], dtype=np.int64),
                    "think": np.asarray(s["think"], dtype=np.float64),
                })
            demand = {"mlp": int(obj["demand"]["mlp"]), "streams": streams}
        return cls(meta=dict(obj["meta"]), cmds=cmds, demand=demand)


class CmdRecorder:
    """Accumulates `Cmd` records during a run; `trace()` canonicalizes.

    `emit` takes the engines' flat global-bank index ``gb`` and derives
    ``(ch, rank, bank)`` from the hierarchy in ``meta``
    (``gb = (ch*n_ranks + rank)*n_banks + bank``); `emit_rank` takes the
    flat global-rank index ``gr = gb // n_banks`` for rank-level ops.
    """

    def __init__(self, meta: dict):
        self.meta = dict(meta)
        self._nb = int(meta["n_banks"])
        self._nr = int(meta["n_ranks"])
        self.cmds: List[Cmd] = []

    def emit(self, tick, op, gb, sub=-1, row=-1, data=-1):
        gr = gb // self._nb
        self.cmds.append(Cmd(tick, op, gr // self._nr, gr % self._nr,
                             gb % self._nb, sub, row, data))

    def emit_rank(self, tick, op, gr, data=-1):
        self.cmds.append(Cmd(tick, op, gr // self._nr, gr % self._nr,
                             -1, -1, -1, data))

    def trace(self, end, demand: Optional[dict] = None) -> CmdTrace:
        meta = dict(self.meta)
        meta["end"] = end
        return CmdTrace(meta=meta, cmds=sorted(self.cmds, key=_key),
                        demand=demand)


def _base_meta(T, pol, wbuf) -> dict:
    return {
        "policy": pol.name,
        "level": pol.level,
        "ideal": bool(pol.ideal),
        "sarp": bool(pol.sarp),
        "hra": bool(getattr(pol, "hra", False)),
        "density_gb": T.density_gb,
        "n_banks": int(T.n_banks),
        "n_ranks": int(T.n_ranks),
        "n_channels": int(T.n_channels),
        "n_subarrays": int(T.n_subarrays),
        "wbuf_cap": int(wbuf[0]),
        "wbuf_hi": int(wbuf[1]),
        "wbuf_lo": int(wbuf[2]),
    }


def tick_meta(T, pol, dt_ns: float, *, scenario: Optional[str] = None,
              wbuf=(64, 48, 16)) -> dict:
    """Trace meta for the integer-tick clock (`run_ticks` and sweeps).

    Applies the contract quantization ``ticks(x) = max(1, int(x/dt + 0.5))``
    to every `TIMING_FIELDS` constant, identically to
    `TickTiming.from_density` / `run_ticks`.
    """
    def tk(ns):
        return max(1, int(ns / dt_ns + 0.5))

    REFI = tk(T.tREFI)
    B = T.n_banks_total
    m = _base_meta(T, pol, wbuf)
    m.update({
        "clock": "tick", "dt_ns": float(dt_ns), "scenario": scenario,
        "REFI": REFI, "REFI_PB": max(1, REFI // B),
        "RFC_AB": tk(T.tRFC_ab), "RFC_PB": tk(T.tRFC_pb),
        "TRP": tk(T.tRP), "HIT": tk(T.row_hit), "MISS": tk(T.row_miss),
        "WR": tk(T.tWR), "TURN": tk(T.tWTR), "RTR": tk(T.tRTR),
        "SARP_PEN": tk(T.sarp_penalty), "BUDGET": int(T.refresh_budget),
    })
    return m


def event_meta(T, pol, *, scenario: Optional[str] = None,
               wbuf=(64, 48, 16)) -> dict:
    """Trace meta for the event-mode ns clock (`DramSim.run`).

    Same `TIMING_FIELDS` keys as `tick_meta` but carrying raw-ns
    values: event mode is deliberately *not* the tick contract
    (tick-contract section 5), so the validator applies sequencing and
    budget rules only and skips the minimum-latency rule.
    """
    B = T.n_banks_total
    m = _base_meta(T, pol, wbuf)
    m.update({
        "clock": "ns", "dt_ns": None, "scenario": scenario,
        "REFI": float(T.tREFI), "REFI_PB": float(T.tREFI) / B,
        "RFC_AB": float(T.tRFC_ab), "RFC_PB": float(T.tRFC_pb),
        "TRP": float(T.tRP), "HIT": float(T.row_hit),
        "MISS": float(T.row_miss), "WR": float(T.tWR),
        "TURN": float(T.tWTR), "RTR": float(T.tRTR),
        "SARP_PEN": float(T.sarp_penalty), "BUDGET": int(T.refresh_budget),
    })
    return m
