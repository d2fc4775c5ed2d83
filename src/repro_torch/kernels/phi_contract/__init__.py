from .ops import phi_link_term, phi_loads  # noqa: F401
from .ref import phi_link_term_ref, phi_loads_ref  # noqa: F401
