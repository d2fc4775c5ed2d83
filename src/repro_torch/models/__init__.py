"""The model-zoo substrate (`models/` of the JAX package): configuration,
layers, the Mamba-2 mixer (`ssm`), weight-only int8 storage (`quant`), the
model entry points of every executable family (forward, the training loss,
prefill, decode), and the bridge from the JAX package's parameter and
optimizer trees (`convert`)."""
from .config import SHAPES, ModelConfig, ShapeConfig, shape_applicable  # noqa: F401
from .model import (  # noqa: F401
    ParamTree,
    decode_step,
    encode,
    forward,
    init_caches,
    init_params,
    logits_fn,
    loss_fn,
    prefill,
    trainable,
)
from .quant import dequantize_params, quantize_params  # noqa: F401
