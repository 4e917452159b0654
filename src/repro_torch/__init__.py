"""PyTorch/CUDA port of the DRAM-refresh reproduction (`repro`, the JAX
package beside this one, stays the reference).

Ported so far:

  * the sweep path in both modes — registry policies,
    `DramSim.run_ticks`, `SweepSpec` -> `sweep()` -> `CellResult` — with
    the tick-loop megakernels and the arbitration kernel written in CUDA
    C++ for Hopper (`repro_torch.kernels`), and the figures, benches and
    tools that run it;
  * the float-kernel entry point `repro_torch.kernels.ops` (paged int8
    decode attention, KV quantization, flash attention, Mamba2 SSD), also
    in CUDA C++;
  * all five model families (`dense` and `moe` transformers, `ssm`
    Mamba2, the `hybrid` and the `encdec`) with serving — the paged int8
    KV cache, the request-lifecycle `EngineCore`, the co-simulation and
    `launch.serve` — kernel E every prefill and training attention, F
    every Mamba layer's SSD, D the cache's page compression;
  * training: the optimizer, the train step (gradients through E and F),
    the data pipeline, the DARP checkpoint engine, the trainer and
    `launch.train`;
  * the contract checker `repro_torch.analysis` (the reference's passes on
    the port's files, `cuda-lint` in place of the Pallas lint;
    `tools/check_contract_torch.py`) and the one-card dry run
    (`launch.specs`, `launch.dryrun`, `parallel.op_analysis`: every
    arch x shape cell's step on `meta`, counted against one H100).

The package imports `torch` and `numpy`, never `jax`, and nothing of
`repro`; `repro_torch.analysis` imports neither torch nor numpy.

    from repro_torch.core.sweep import SweepSpec, sweep
    res = sweep(SweepSpec(policies=("ideal", "ref_ab", "dsarp"),
                          scenarios=("closed_mixed",), densities=(8, 32),
                          mode="closed"))            # on the card
    res = sweep(spec, device="cpu")                  # plain PyTorch path

    PYTHONPATH=src python -m repro_torch.launch.serve --mixed   # on the card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b
"""
