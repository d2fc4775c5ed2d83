from .ops import placement_sweep  # noqa: F401
from .ref import sequential_sweep  # noqa: F401
