"""The paper's Fig. 1 for the model zoo: per-architecture split profiles
(`profile`), the split-point Pareto search over them (`pareto`), and the
data plane, a model of any family split at a layer boundary (encoder /
decoder for encdec) run as two partitions (`executor`)."""
from .profile import (  # noqa: F401
    ArchProfile,
    apps_from_profiles,
    enumerate_candidates,
    flops_per_token_layer,
    profile_arch,
)
from .pareto import check_fronts, pareto_front, sweep_zoo  # noqa: F401
from .executor import run_partition, split_params  # noqa: F401
