"""Replay a command trace through `DramSim.run_ticks`.

Two ingestion modes:

* **Captured traces** (emitted with ``record_commands=True``) carry the
  originating raw per-core demand streams in ``trace.demand``; replaying
  re-drives `run_ticks` with the same timing, policy, and write-buffer
  configuration and is **bit-identical** to the originating run — the
  re-emitted trace equals the input command-for-command (`round_trip`).
* **External traces** (no ``demand``) are converted by
  `demand_from_commands` into a single in-order demand stream whose
  arrivals reproduce the trace's RD/WR timing as open-loop think gaps.
  Replay is deterministic but *not* bit-identical — the original
  controller's policy decisions are re-made by whatever policy the
  replay runs.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.commands.trace import CmdTrace


class ReplayWorkload:
    """Duck-typed stand-in for `Workload` replaying captured streams.

    Exposes exactly what `DramSim` consumes: ``mlp``, ``n_cores``, and
    ``generate(n_banks, n_subarrays, ...)`` returning per-core dicts of
    ``is_write/bank/row/subarray/think`` arrays (think in raw ns, ahead
    of the contract quantization inside the engines).
    """

    def __init__(self, streams: List[dict], mlp: int,
                 name: str = "trace_replay"):
        self.name = name
        self.mlp = int(mlp)
        self._streams = [
            {
                "is_write": np.asarray(s["is_write"], dtype=bool),
                "bank": np.asarray(s["bank"], dtype=np.int64),
                "row": np.asarray(s["row"], dtype=np.int64),
                "subarray": np.asarray(s["subarray"], dtype=np.int64),
                "think": np.asarray(s["think"], dtype=np.float64),
            }
            for s in streams
        ]

    @property
    def n_cores(self) -> int:
        return len(self._streams)

    def generate(self, n_banks, n_subarrays, n_rows=4096):
        return self._streams


def timing_from_meta(meta: dict):
    """Rebuild the `DramTiming` a trace was emitted under."""
    from repro_torch.core.refresh.timing import timing_for_density

    return timing_for_density(
        meta["density_gb"],
        n_banks=meta["n_banks"],
        n_subarrays=meta["n_subarrays"],
        n_ranks=meta["n_ranks"],
        n_channels=meta["n_channels"],
    )


def demand_from_commands(trace: CmdTrace) -> ReplayWorkload:
    """Synthesize a demand stream from an external trace's RD/WR records.

    Builds one in-order core whose think gaps reproduce the inter-command
    tick deltas (scaled back to ns by ``meta["dt_ns"]``), with ``mlp``
    equal to the request count so reads never stall the stream — the
    replayed engine then re-makes its own refresh decisions against the
    original access pattern.
    """
    m = trace.meta
    dt = m.get("dt_ns") or 1.0
    NB, NR = int(m["n_banks"]), int(m["n_ranks"])
    S = int(m["n_subarrays"])
    rw = [c for c in trace.cmds if c.op in ("RD", "WR")]
    if not rw:
        raise ValueError("trace has no RD/WR commands to replay")
    arrive = [float(c.tick) for c in rw]
    think = [(arrive[k + 1] - arrive[k]) * dt for k in range(len(rw) - 1)]
    think.append(0.0)
    rows = [c.row for c in rw]
    subs = [c.sub if c.sub >= 0 else c.row % S for c in rw]
    gbs = [(c.ch * NR + c.rank) * NB + c.bank for c in rw]
    stream = {
        "is_write": np.asarray([c.op == "WR" for c in rw], dtype=bool),
        "bank": np.asarray(gbs, dtype=np.int64),
        "row": np.asarray(rows, dtype=np.int64),
        "subarray": np.asarray(subs, dtype=np.int64),
        "think": np.asarray(think, dtype=np.float64),
    }
    return ReplayWorkload([stream], mlp=len(rw))


def replay_trace(trace: CmdTrace, *, policy: Optional[str] = None,
                 record_commands: bool = True):
    """Re-drive `DramSim.run_ticks` from ``trace``; return the `SimResult`.

    Captured traces replay their stored demand bit-identically under the
    trace's own policy (override with ``policy`` to counterfactually
    re-schedule the same demand); external traces go through
    `demand_from_commands` first.
    """
    from repro_torch.core.refresh.sim import DramSim

    m = trace.meta
    if m.get("clock", "tick") != "tick":
        raise ValueError("only tick-clock traces replay through run_ticks "
                         "(event-mode ns traces are a different contract, "
                         "docs/tick-contract.md section 5)")
    T = timing_from_meta(m)
    if trace.demand is not None:
        wl = ReplayWorkload(trace.demand["streams"], trace.demand["mlp"])
    else:
        wl = demand_from_commands(trace)
    sim = DramSim(T, wl, policy or m["policy"],
                  wbuf_cap=m.get("wbuf_cap", 64),
                  wbuf_hi=m.get("wbuf_hi", 48),
                  wbuf_lo=m.get("wbuf_lo", 16))
    return sim.run_ticks(dt_ns=m["dt_ns"], record_commands=record_commands)


def traces_equal(a: CmdTrace, b: CmdTrace) -> bool:
    """Command-for-command equality plus the timing/identity meta keys."""
    from repro_torch.core.commands.trace import TIMING_FIELDS, _key

    keys = TIMING_FIELDS + ("policy", "level", "clock", "dt_ns", "n_banks",
                            "n_ranks", "n_channels", "n_subarrays", "end")
    if any(a.meta.get(k) != b.meta.get(k) for k in keys):
        return False
    return sorted(a.cmds, key=_key) == sorted(b.cmds, key=_key)


def round_trip(trace: CmdTrace):
    """Replay ``trace`` and report ``(result, bit_identical)``."""
    res = replay_trace(trace, record_commands=True)
    return res, traces_equal(trace, res.commands)
