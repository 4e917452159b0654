#!/usr/bin/env python3
"""Command-contract smoke of the PyTorch/CUDA port (`repro_torch`): emit,
validate, and round-trip every policy. The counterpart of
`tools/check_commands.py`.

    python3 tools/check_commands_torch.py [--reqs N] [--seed N]

For every registered policy this drives a small closed-loop
`DramSim.run_ticks` matrix (n_ranks x n_subarrays), emits the DFI-style
command trace, runs the JEDEC sequencing validator
(`repro_torch.core.commands.validate_trace`), and checks the emit ->
replay round trip is bit-identical. One batched-sweep cell cross-checks
that the sweep backend emits the identical trace. Runs on the host only.

Exit status: 0 when every trace is violation-free and every round trip
is bit-identical, 1 otherwise.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT / "src"))

from repro_torch.core.commands import (round_trip, traces_equal,  # noqa: E402
                                       validate_trace)
from repro_torch.core.policy import list_policies  # noqa: E402
from repro_torch.core.refresh import DramSim, make_closed_workload  # noqa: E402
from repro_torch.core.refresh.timing import timing_for_density  # noqa: E402
from repro_torch.core.sweep import SweepSpec, sweep  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="check_commands_torch.py")
    ap.add_argument("--reqs", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    t0 = time.time()
    problems = []
    n_traces = n_cmds = 0
    for policy in list_policies():
        for scenario in ("closed_mixed", "closed_write_heavy"):
            for n_ranks, n_subarrays in ((1, 1), (2, 4)):
                label = f"{policy}/{scenario}/R{n_ranks}S{n_subarrays}"
                T = timing_for_density(32, n_ranks=n_ranks,
                                       n_subarrays=n_subarrays)
                wl = make_closed_workload(scenario, args.reqs, args.seed)
                res = DramSim(T, wl, policy).run_ticks(record_commands=True)
                n_traces += 1
                n_cmds += len(res.commands)
                vio = validate_trace(res.commands, limit=3)
                if vio:
                    problems.append(f"{label}: {vio[0]}")
                    continue
                _, bit_identical = round_trip(res.commands)
                if not bit_identical:
                    problems.append(f"{label}: round trip not bit-identical")

    # one sweep cell: the batched backend must emit the identical trace
    spec = SweepSpec(policies=("dsarp",), scenarios=("closed_mixed",),
                     densities=(32,), reqs=args.reqs, seed=args.seed,
                     n_ranks=2, mode="closed")
    swept = sweep(spec, "batched", record_commands=True)
    tr = swept.commands_for("dsarp", "closed_mixed", 32)
    wl = make_closed_workload("closed_mixed", args.reqs, args.seed)
    ref = DramSim(timing_for_density(32, n_ranks=2), wl, "dsarp").run_ticks(
        record_commands=True).commands
    if validate_trace(tr, limit=3):
        problems.append("sweep cell: emitted trace has violations")
    if not traces_equal(tr, ref):
        problems.append("sweep cell: batched emission != run_ticks emission")

    for p in problems:
        print(f"FAIL {p}")
    status = "FAILED" if problems else "ok"
    print(f"check_commands: {n_traces} traces, {n_cmds} commands, "
          f"{len(problems)} problem(s), {time.time() - t0:.1f}s ({status})")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
