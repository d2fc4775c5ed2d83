from .ops import update_phi  # noqa: F401
from .ref import link_delta, update_phi_ref  # noqa: F401
