from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    AbstractMesh,
    ShardingRules,
    Spec,
    logical_axis_rules,
    logical_to_spec,
    lshard,
)

__all__ = [
    "DEFAULT_RULES",
    "AbstractMesh",
    "ShardingRules",
    "Spec",
    "logical_axis_rules",
    "logical_to_spec",
    "lshard",
]
