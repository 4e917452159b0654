# Hand-written CUDA kernels of the port (sources under csrc/, built by
# _build.py at first use) with their wrappers and plain PyTorch versions:
# sweep_arbiter (per-tick arbitration scoring) and sweep_megakernel (the
# whole tick loop, one cell per thread, both modes); and the float
# kernels behind `ops` (the names of `repro.kernels.ops`): kv_quant,
# refresh_paged_attention, flash_attention and mamba2_ssd, with their
# oracles in `ref`.
