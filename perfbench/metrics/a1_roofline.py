"""Kernel A1's (`sweep_mega_closed_kernel`, kernels/csrc/sweep_megakernel.cu)
share of its roofline, percent: the least time the card could take for
the window's tick loops, the frozen operation count
(`counts/sweep_ops.closed_operations`) at the int32 peak, over the
kernel's device time in the trace. Its bytes (the demand planes and one
stat row a cell) are under a thousandth of that bound's time at the HBM
rate, so the operations bound it."""
from perfbench.counts.peaks import INT32_OPS
from perfbench.metrics import kernel_seconds


def read(data):
    ops = data["counters"].get("a1_operations")
    t = kernel_seconds(data, "sweep_mega_closed_kernel")
    if not ops or t <= 0:
        return None
    return 100.0 * (ops / INT32_OPS) / t
