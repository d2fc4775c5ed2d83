"""Parameters between the JAX package's trees and the port's `ParamTree`.

The JAX package keeps a model's parameters as a nested dict with the
layers stacked on axis 0 (`params["blocks"]["attn"]["wq"]` is [L, d, H, hd]).
`params_from_jax` takes that tree with numpy leaves (`jax.tree.map(np.asarray,
params)`) and splits the stacked leaves (`blocks`, and `dec_blocks` of an
encoder-decoder) into one module per layer, keeping every shape and dtype;
`params_to_numpy` is the inverse. A quantized leaf {"__q": int8, "__s"}
crosses as it is; under the stacked subtrees its per-layer scales [L]
become one scalar a layer, and stack back to [L]. numpy has no
bfloat16 of its own, so a bfloat16 leaf arrives as the 2-byte dtype named
"bfloat16" that JAX hands out (read through its raw bits) and leaves as
float32, which holds every bfloat16 value exactly.

Training state crosses the same way. The port keys gradients and AdamW
moments by parameter name (`blocks.0.attn.wq`); `named_to_numpy` stacks
such a dict into the JAX tree, and `opt_state_from_jax` /
`opt_state_to_numpy` move a whole AdamW state ({"mu", "nu", "step"}), so a
run can start from the same optimizer state in both packages and a test
can compare them leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .model import ParamTree
from .quant import STACKED


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(cfg: ModelConfig, tree: dict, *, device="cuda") -> ParamTree:
    """The JAX package's parameter tree (numpy leaves) as the port's model."""
    dev = resolve_device(device)
    out = {k: _map(v, lambda a: _leaf(a, dev)) for k, v in tree.items() if k not in STACKED}
    for name, n_layers in (("blocks", cfg.n_layers), ("dec_blocks", cfg.n_dec_layers)):
        if name in tree:
            out[name] = [
                _map(tree[name], lambda a, l=l: _leaf(np.asarray(a)[l], dev)) for l in range(n_layers)
            ]
    return ParamTree(out)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of a CPU parameter, which training
    updates in place)."""
    t = t.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tree_of(module) -> dict:
    out = {name: _to_numpy(p) for name, p in module.named_parameters(recurse=False)}
    out.update({name: _tree_of(m) for name, m in module.named_children()})
    return out


def params_to_numpy(params: ParamTree) -> dict:
    """The port's model as the JAX package's tree: numpy leaves, layers
    stacked on axis 0, bfloat16 leaves widened to float32."""
    out = {name: _to_numpy(p) for name, p in params.named_parameters(recurse=False)}
    for name, m in params.named_children():
        out[name] = _stack([_tree_of(b) for b in m]) if name in STACKED else _tree_of(m)
    return out


def _stack(layers: list):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in layers]) for k in first}
    return np.stack(layers)


def named_to_numpy(named: dict) -> dict:
    """{dotted parameter name: tensor} (gradients, moments) as the JAX
    package's tree: numpy leaves, layers stacked on axis 0."""
    nested: dict = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        d = nested
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = _to_numpy(t)
    for name in STACKED:
        if name in nested:
            layers = nested[name]
            nested[name] = _stack([layers[str(l)] for l in range(len(layers))])
    return nested


def opt_state_from_jax(cfg: ModelConfig, opt: dict, *, device="cuda") -> dict:
    """The JAX package's AdamW state (numpy leaves) as the port's: fp32
    moments keyed by parameter name and the int32 step, on `device`."""
    dev = resolve_device(device)

    def named(tree):
        return {n: p.detach() for n, p in params_from_jax(cfg, tree, device=dev).named_parameters()}

    step = torch.tensor(np.asarray(opt["step"]), dtype=torch.int32, device=dev)
    return {"mu": named(opt["mu"]), "nu": named(opt["nu"]), "step": step}


def opt_state_to_numpy(opt: dict) -> dict:
    """The port's AdamW state as the JAX package's tree of numpy leaves."""
    return {"mu": named_to_numpy(opt["mu"]), "nu": named_to_numpy(opt["nu"]),
            "step": np.asarray(opt["step"].cpu())}
