"""Step configuration for serving (the serve part of the JAX package's
`launch/steps.py`; its train and prefill step builders wait for the
training slice)."""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig


def serve_config(cfg: ModelConfig) -> ModelConfig:
    """Serving stores parameters in bf16 (no fp32 master needed)."""
    return dataclasses.replace(cfg, param_dtype="bfloat16", remat=False)
