"""The optimizer (the JAX package's `optim/`): AdamW with global-norm
clipping and a cosine schedule, and int8 gradient compression."""
from .adamw import adamw_init, adamw_update, clip_by_global_norm, cosine_schedule  # noqa: F401
from .compression import compress_int8, decompress_int8  # noqa: F401
