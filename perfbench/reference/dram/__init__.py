"""Frozen copy of the port's closed-loop DRAM model: the registry policies
(`policy/`), the timing table, the workload generators and closed
scenarios (`make_closed_demand`), and `DramSim.run_ticks`, the per-request
tick-contract oracle. Copied from `repro_torch/core/{policy,refresh}` and
`core/sweep/{arbiter,fields}` with the imports pointed here; command
recording and the open-loop trace replay are left out. It imports nothing
of the program, so a later change to the program cannot move it."""
