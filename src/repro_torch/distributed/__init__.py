"""Sharding rules (`sharding.py`: the dry run's substrate specs and the
fleet's instance-axis layout) and the GPipe schedule (`pipeline.py`), the
JAX package's `distributed/`. The activation constraints of its `act.py`
wait for the model-parallel slice (ROADMAP.md, 'Modules to port', item 3b)."""
from .sharding import (  # noqa: F401
    FLEET_AXIS,
    ShardingRules,
    batch_pspec,
    cache_pspecs,
    carries_fleet_sharding,
    fleet_pspec,
    fleet_sharding,
    param_pspecs,
    shard_fleet,
    to_named_shardings,
)
from .pipeline import pipeline_apply  # noqa: F401
