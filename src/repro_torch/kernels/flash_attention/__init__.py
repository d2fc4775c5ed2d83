from .ops import flash_attention  # noqa: F401
from .ref import M_INIT, NEG, attention_chunked, attention_ref  # noqa: F401
