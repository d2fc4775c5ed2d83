"""The training data stream (the JAX package's `data/`)."""
from .pipeline import DataConfig, SyntheticLM, make_pipeline  # noqa: F401
