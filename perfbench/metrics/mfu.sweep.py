"""The whole sweep's share of the card's peak, percent: the frozen
operation count of every tick loop the window ran
(`counts/sweep_ops.closed_operations`) over the traced window's length at
the int32 peak. A later change that takes A1 off the path leaves
`a1_roofline` silent; this still bounds it."""
from perfbench.counts.peaks import INT32_OPS
from perfbench.metrics import window_seconds


def read(data):
    ops = data["counters"].get("a1_operations")
    w = window_seconds(data)
    if not ops or w <= 0:
        return None
    return 100.0 * ops / (w * INT32_OPS)
