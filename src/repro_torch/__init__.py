"""PyTorch/CUDA port of the DRAM-refresh reproduction (`repro`, the JAX
package beside this one, stays the reference).

Ported so far: the sweep path in both modes — registry policies,
`DramSim.run_ticks`, `SweepSpec` -> `sweep()` -> `CellResult` — with the
tick-loop megakernels and the arbitration kernel written in CUDA C++ for
Hopper (`repro_torch.kernels`); and the float-kernel entry point
`repro_torch.kernels.ops` (paged int8 decode attention, KV quantization,
flash attention, Mamba2 SSD), also in CUDA C++. The package imports
`torch` and `numpy`, never `jax`, and nothing of `repro`.

    from repro_torch.core.sweep import SweepSpec, sweep
    res = sweep(SweepSpec(policies=("ideal", "ref_ab", "dsarp"),
                          scenarios=("closed_mixed",), densities=(8, 32),
                          mode="closed"))            # on the card
    res = sweep(spec, device="cpu")                  # plain PyTorch path
"""
