from .ops import (  # noqa: F401
    DEFAULT_TOL,
    NEUMANN_SLACK,
    effective_hops,
    neumann_propagate,
    neumann_solve,
)
from .ref import lu_solve_ref, neumann_propagate_ref  # noqa: F401
