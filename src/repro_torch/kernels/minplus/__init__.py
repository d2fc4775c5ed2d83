from .ops import (  # noqa: F401
    apsp,
    apsp_with_nexthop,
    minplus_closure,
    minplus_matmul,
    minplus_matmul_argmin,
    squaring_bound,
)
from .ref import (  # noqa: F401
    minplus_matmul_argmin_blocked,
    minplus_matmul_argmin_ref,
    minplus_matmul_blocked,
    minplus_matmul_ref,
)
