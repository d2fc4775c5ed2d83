"""Sharding rules and layouts (`sharding.py`: the substrate's partition
specs, the fleet's instance-axis layout, laying a model, its batch and its
caches out as DTensors), the activation constraints (`act.py`), the
vocab-parallel lookup and loss (`vocab.py`) and the GPipe schedule
(`pipeline.py`): the JAX package's `distributed/`."""
from .act import activation_sharding, shard  # noqa: F401
from .sharding import (  # noqa: F401
    FLEET_AXIS,
    ShardingRules,
    batch_pspec,
    cache_pspecs,
    carries_fleet_sharding,
    distribute_batch,
    distribute_caches,
    distribute_params,
    fleet_pspec,
    fleet_sharding,
    param_pspecs,
    shard_fleet,
    to_named_shardings,
)
from .pipeline import pipeline_apply  # noqa: F401
