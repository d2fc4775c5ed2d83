"""Weight-only int8 quantization for serving (the JAX package's
`models/quant.py`).

Storage: each large float leaf W becomes a quantized leaf, a `ParamTree`
child holding `__q` (int8, W's shape) and `__s` (a float32 scalar), with
the symmetric per-tensor scale max|W| / 127 (floored at 1e-12) and
q = clip(round(W / s), -127, 127), round half to even. Dequantization runs
per layer inside the layer loops, so the transient copy in the compute
dtype is one layer's leaf, not the model.

The JAX package stacks the layers on axis 0 and decides which leaves to
quantize on the stacked leaf: a leaf of ndim >= 2 and at least 65,536
elements, where a stacked leaf [L, ...] gets one scale per layer. The port
keeps one module per layer, so under `blocks` and `dec_blocks` it decides
on the stacked shape ([L] + the layer's shape: one dim or more a layer, L
times the layer's size) and quantizes each layer with its own scale;
at full depth this quantizes, for example, mamba2-370m's `ssm_norm`
([48, 2048] stacked) as the reference does. Every other leaf (`embed`,
`lm_head`, `frontend_proj`) is decided on its own shape and gets one scale.
"""
from __future__ import annotations

import torch
from torch import nn

_MIN_QUANT_SIZE = 1 << 16  # don't quantize norms/biases/small tables
# The per-layer subtrees, which JAX stacks on axis 0 (`convert.py` too).
STACKED = ("blocks", "dec_blocks")


def is_quantized_leaf(x) -> bool:
    """A quantized leaf: a module holding `__q` and `__s`."""
    return isinstance(x, nn.Module) and "__q" in x._parameters


def quantize_leaf(w: torch.Tensor) -> dict:
    """{"__q": int8, "__s": float32 scalar}, one scale for the whole tensor.

    JAX's `quantize_leaf(w, per_layer=True)` of a stacked leaf is this,
    layer by layer. max|W| is exact in any float dtype; the division and
    rounding run in float32 on a copy, in place."""
    scale = torch.clamp_min(w.abs().amax().float() / 127.0, 1e-12)
    q = w.to(torch.float32, copy=True).div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return {"__q": q, "__s": scale}


def dequantize_leaf(x: nn.Module, dtype=torch.bfloat16) -> torch.Tensor:
    return (getattr(x, "__q").float() * getattr(x, "__s")).to(dtype)


def _eligible(t: torch.Tensor, n_layers: int | None) -> bool:
    """JAX's `_eligible` on the reference's shape: the stacked [L, ...]
    leaf when `n_layers` is given, else the leaf itself."""
    if not t.is_floating_point():
        return False
    if n_layers is None:
        return t.dim() >= 2 and t.numel() >= _MIN_QUANT_SIZE
    return t.dim() >= 1 and n_layers * t.numel() >= _MIN_QUANT_SIZE


def _quantize_tree(module: nn.Module, n_layers: int | None) -> dict:
    out = {}
    for name, p in module.named_parameters(recurse=False):
        out[name] = quantize_leaf(p.detach()) if _eligible(p, n_layers) else p
    for name, child in module.named_children():
        if is_quantized_leaf(child):
            out[name] = child
        elif name in STACKED and n_layers is None:
            out[name] = [_quantize_tree(layer, len(child)) for layer in child]
        else:
            out[name] = _quantize_tree(child, n_layers)
    return out


def quantize_params(params: nn.Module) -> nn.Module:
    """Quantize every large float leaf of a `ParamTree` (module doc for the
    rule). Leaves that stay float are shared with `params`, not copied."""
    from .model import ParamTree

    return ParamTree(_quantize_tree(params, None))


def _dequantize_tree(module: nn.Module, dtype) -> dict:
    out = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        if is_quantized_leaf(child):
            out[name] = dequantize_leaf(child, dtype)
        elif isinstance(child, nn.ModuleList):
            out[name] = [_dequantize_tree(m, dtype) for m in child]
        else:
            out[name] = _dequantize_tree(child, dtype)
    return out


def dequantize_params(params: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Inverse of `quantize_params` (applied per layer inside the layer
    loops). A module without quantized leaves is returned as it is."""
    if not any(is_quantized_leaf(m) for m in params.modules()):
        return params
    from .model import ParamTree

    return ParamTree(_dequantize_tree(params, dtype))
