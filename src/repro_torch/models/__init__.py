"""The dense-decoder model substrate (`models/` of the JAX package, dense
family): configuration, layers, the model entry points, and the bridge
from the JAX package's parameter trees (`convert`)."""
from .config import SHAPES, ModelConfig, ShapeConfig, shape_applicable  # noqa: F401
from .model import (  # noqa: F401
    ParamTree,
    decode_step,
    forward,
    init_caches,
    init_params,
    logits_fn,
    prefill,
)
