"""Published peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet,
dense rates without sparsity, at the full 700 W power limit; a card set
below it runs slower, so every result line is read beside the card's
name and `PERF.md` keeps its power limit).

The sweep kernels do int32 arithmetic: an SM issues int32 on half of its
float32 lanes, and the float32 figure counts a fused multiply-add as two
operations, so the int32 rate is a quarter of the float32 FLOP rate
(the arithmetic `chip_smoke.py` uses for its bounds).
"""
#: float32 outside the tensor cores, FLOP/s
FP32_FLOPS = 67e12
#: TF32 on the tensor cores, FLOP/s
TF32_TC_FLOPS = 495e12
#: int32 operations a second, as above
INT32_OPS = FP32_FLOPS / 4
#: device memory bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
