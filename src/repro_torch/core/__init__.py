# repro_torch.core mirrors repro.core module for module:
# policy (the pluggable refresh-policy API), refresh (DRAM timing,
# workloads, scenarios, DramSim), commands (DFI-style command layer) and
# sweep (the batched scenario-sweep engine and its torch tick body).
