"""Atomic, keep-K, device-agnostic checkpoints (the JAX package's
`checkpoint/`)."""
from .manager import CheckpointManager  # noqa: F401
