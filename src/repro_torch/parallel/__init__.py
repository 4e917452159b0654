"""The reference's `parallel/` on one card: `op_analysis`, the dry run's
FLOPs / bytes / roofline instrument (the counterpart of `hlo_analysis`).

The reference's `sharding` (logical axes onto a TPU mesh) has no
counterpart yet: one card has nothing to shard, and the multi-card slice
over `torch.distributed` is queued in `ROADMAP.md`.
"""
from repro_torch.parallel.op_analysis import (HBM_BW,  # noqa: F401
                                              PEAK_FLOPS, OpAnalysis,
                                              analyze_ops)

__all__ = ["HBM_BW", "PEAK_FLOPS", "OpAnalysis", "analyze_ops"]
