from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    create_mesh,
    gather_state_dict,
    param_sharding_rules,
    shard_state_dict,
    state_sharding_rules,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "create_mesh",
    "gather_state_dict",
    "param_sharding_rules",
    "shard_state_dict",
    "state_sharding_rules",
]
