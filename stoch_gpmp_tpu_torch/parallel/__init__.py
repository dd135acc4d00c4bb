from stoch_gpmp_tpu_torch.parallel.sharding import (
    make_mesh,
    make_sharded_gpmp_optimize,
    make_sharded_optimize,
    replicate,
    shard_gpmp_state,
    shard_planner_state,
)

__all__ = [
    "make_mesh",
    "make_sharded_gpmp_optimize",
    "make_sharded_optimize",
    "replicate",
    "shard_gpmp_state",
    "shard_planner_state",
]
