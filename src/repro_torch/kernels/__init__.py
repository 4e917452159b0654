# Hand-written CUDA kernels of the port (sources under csrc/, built by
# _build.py at first use) with their wrappers and plain PyTorch versions:
# sweep_arbiter (per-tick arbitration scoring) and sweep_megakernel (the
# whole closed-loop tick loop, one cell per thread).
