"""The reference's `parallel/`: `sharding` (logical axes onto a
`torch.distributed` `DeviceMesh`, DTensor placements) and `op_analysis`,
the dry run's FLOPs / bytes / roofline instrument (the counterpart of
`hlo_analysis`)."""
from repro_torch.parallel.op_analysis import (HBM_BW,  # noqa: F401
                                              PEAK_FLOPS, OpAnalysis,
                                              analyze_ops)
from repro_torch.parallel.sharding import (LOGICAL_RULES_MULTI_POD,
                                           LOGICAL_RULES_SINGLE_POD,
                                           NamedSharding, axis_size,
                                           current_mesh, distribute,
                                           logical_to_spec, named_sharding,
                                           set_sharding_context,
                                           sharding_context, shd,
                                           spec_to_placements)

__all__ = [
    "LOGICAL_RULES_SINGLE_POD",
    "LOGICAL_RULES_MULTI_POD",
    "axis_size",
    "logical_to_spec",
    "set_sharding_context",
    "sharding_context",
    "shd",
    "current_mesh",
    "named_sharding",
    "NamedSharding",
    "spec_to_placements",
    "distribute",
    "HBM_BW",
    "PEAK_FLOPS",
    "OpAnalysis",
    "analyze_ops",
]
