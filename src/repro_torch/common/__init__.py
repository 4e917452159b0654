from repro_torch.common.config import (
    ArchConfig,
    AttentionConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    SHAPE_SETS,
    register_arch,
    get_arch,
    list_archs,
    applicable_shapes,
)
from repro_torch.common.treeutil import tree_bytes, tree_param_count

__all__ = [
    "ArchConfig",
    "AttentionConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeConfig",
    "SHAPE_SETS",
    "register_arch",
    "get_arch",
    "list_archs",
    "applicable_shapes",
    "tree_bytes",
    "tree_param_count",
]
