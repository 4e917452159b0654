"""Batched scenario-sweep engine: run (workload, policy, density) grids
in lock-step over stacked state arrays, with the scalar tick loop kept as
a bit-identical reference oracle, a torch tick body, and CUDA kernels for
the whole tick loop and for the per-tick arbitration step.

    from repro_torch.core.sweep import SweepSpec, sweep
    res = sweep(SweepSpec(policies=("ref_pb", "darp", "dsarp"),
                          scenarios=("closed_mixed", "closed_low_mlp"),
                          densities=(8, 32), mode="closed"))
    res.stat("avg_read_latency")       # [P, S, D] array

See `repro_torch.core.refresh.scenarios` for the workload library and
`docs/architecture.md` for where this sits in the stack.
"""
from repro_torch.core.sweep.engine import (CellResult, SweepResult,
                                           SweepSpec, TickTiming, sweep)

__all__ = ["CellResult", "SweepResult", "SweepSpec", "TickTiming", "sweep"]
