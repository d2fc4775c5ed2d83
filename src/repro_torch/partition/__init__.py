"""The data plane of the paper's Fig. 1 for the dense family: a model split
at a layer boundary runs as two partitions (`executor`). The profile and
split-point search of the JAX package's `partition/` are not ported yet."""
from .executor import run_partition, split_params  # noqa: F401
