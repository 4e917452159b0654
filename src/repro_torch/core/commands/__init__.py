"""Controller-grade DRAM command layer.

The engines expose tick-level *outcomes*; this package makes their
*command behavior* auditable against real-controller semantics:

* `trace`     — DFI-style command records (`Cmd` / `CmdTrace`) and the
                `CmdRecorder` the emission hooks in `DramSim` and the
                batched sweep backend feed (`record_commands=True`),
* `validator` — a streaming JEDEC sequencing checker (litedram-style
                Precharge-All -> tRP -> REF -> tRFC, postpone/pull-in
                budget, minimum command-to-data latency) returning named
                `Violation` records,
* `replay`    — re-drive `DramSim.run_ticks` from a captured (or
                external) trace; emit -> validate -> replay round-trips
                bit-identically.

Normative spec: docs/tick-contract.md section 7.
"""
from repro_torch.core.commands.trace import (MNEMONICS, TIMING_FIELDS, Cmd,
                                       CmdRecorder, CmdTrace, event_meta,
                                       tick_meta)
from repro_torch.core.commands.validator import RULES, Violation, validate_trace
from repro_torch.core.commands.replay import (ReplayWorkload, demand_from_commands,
                                        replay_trace, round_trip,
                                        traces_equal)

__all__ = [
    "MNEMONICS", "TIMING_FIELDS", "Cmd", "CmdRecorder", "CmdTrace",
    "tick_meta", "event_meta",
    "RULES", "Violation", "validate_trace",
    "ReplayWorkload", "demand_from_commands", "replay_trace", "round_trip",
    "traces_equal",
]
