"""PyTorch/CUDA port of the DRAM-refresh reproduction (`repro`, the JAX
package beside this one, stays the reference).

Ported so far: the closed-loop sweep path — registry policies,
`DramSim.run_ticks`, `SweepSpec` -> `sweep()` -> `CellResult` — with the
tick-loop megakernel and the arbitration kernel written in CUDA C++ for
Hopper (`repro_torch.kernels`). The package imports `torch` and `numpy`,
never `jax`, and nothing of `repro`.

    from repro_torch.core.sweep import SweepSpec, sweep
    res = sweep(SweepSpec(policies=("ideal", "ref_ab", "dsarp"),
                          scenarios=("closed_mixed",), densities=(8, 32),
                          mode="closed"))            # on the card
    res = sweep(spec, device="cpu")                  # plain PyTorch path
"""
