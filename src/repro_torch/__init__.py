"""PyTorch/CUDA port of the DRAM-refresh reproduction (`repro`, the JAX
package beside this one, stays the reference).

Ported so far: the sweep path in both modes — registry policies,
`DramSim.run_ticks`, `SweepSpec` -> `sweep()` -> `CellResult` — with the
tick-loop megakernels and the arbitration kernel written in CUDA C++ for
Hopper (`repro_torch.kernels`); and the float-kernel entry point
`repro_torch.kernels.ops` (paged int8 decode attention, KV quantization,
flash attention, Mamba2 SSD), also in CUDA C++; and the serving path
for the transformer family (dense and MoE models, the paged int8 KV cache,
the request-lifecycle `EngineCore`, the co-simulation and
`launch.serve`), with kernel E as the models' causal attention in
`forward`/`prefill` and kernel D as the cache's page compression. The
package imports `torch` and `numpy`, never `jax`, and nothing of `repro`.

    from repro_torch.core.sweep import SweepSpec, sweep
    res = sweep(SweepSpec(policies=("ideal", "ref_ab", "dsarp"),
                          scenarios=("closed_mixed",), densities=(8, 32),
                          mode="closed"))            # on the card
    res = sweep(spec, device="cpu")                  # plain PyTorch path

    PYTHONPATH=src python -m repro_torch.launch.serve --mixed   # on the card
"""
