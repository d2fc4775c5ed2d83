"""Model assembly for the dense family: blocks, layer stacks, and the public
forward / prefill / decode entry points (the dense part of the JAX
package's `models/model.py`).

Parameters live in a `ParamTree`, an `nn.Module` whose names follow the
JAX leaves: `embed.embed` (+ `embed.lm_head` when untied), `final_norm`,
and per layer `blocks.{l}.norm1`, `blocks.{l}.attn.wq` ... `blocks.{l}.mlp.wo`.
Where JAX stacks the layers on axis 0 and scans over them, the port keeps
one child module per layer and loops. The functions run on the device the
parameters live on; `init_params` takes `device=` (default "cuda", which
raises without a GPU).

Batch format: {"tokens": integer [B, S]}. Decode: {"token"} [B, 1] plus
per-layer caches (a list of {"attn": {"k", "v"}}, where JAX stacks them)
and an integer position.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import layers as L
from .config import ModelConfig


class ParamTree(nn.Module):
    """A nested dict of tensors as modules and parameters: a dict becomes a
    child module, a list an `nn.ModuleList`, a tensor a parameter (no
    gradient: the port serves, it does not train). Modules and parameters
    passed in are shared, not copied."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, nn.Parameter):
                self.register_parameter(name, v)
            elif isinstance(v, torch.Tensor):
                self.register_parameter(name, nn.Parameter(v, requires_grad=False))
            elif isinstance(v, nn.Module):
                self.add_module(name, v)
            elif isinstance(v, (list, tuple)):
                self.add_module(name, nn.ModuleList(
                    t if isinstance(t, nn.Module) else ParamTree(t) for t in v
                ))
            else:
                self.add_module(name, ParamTree(v))


def params_device(params: nn.Module) -> torch.device:
    return next(params.parameters()).device


def require_dense(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet."""
    todo = "is not ported yet; see ROADMAP.md, 'Modules to port', item 6"
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family {todo}")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend!r} modality frontend {todo}")
    if cfg.quantize_int8:
        raise NotImplementedError(f"{cfg.name}: int8 weight storage {todo}")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    p = {"norm1": L.init_norm(d, gen.device), "attn": L.init_attention(gen, cfg)}
    if not cfg.parallel_block:
        p["norm2"] = L.init_norm(d, gen.device)
    p["mlp"] = L.init_mlp(gen, cfg)
    return p


def _block_full(p, x, cfg: ModelConfig, *, want_cache=False, total_len=0):
    h = L.rmsnorm(x, p.norm1, cfg.norm_eps)
    attn_out, k_rot, v = L.attention_full(p.attn, h, cfg)
    cache = {"attn": L.prefill_cache(k_rot, v, cfg, total_len)} if want_cache else None
    if cfg.parallel_block:
        x = x + attn_out + L.mlp_apply(p.mlp, h, cfg)
    else:
        x = x + attn_out
        x = x + L.mlp_apply(p.mlp, L.rmsnorm(x, p.norm2, cfg.norm_eps), cfg)
    return x, cache


def _block_decode(p, x, cache, pos: int, cfg: ModelConfig):
    h = L.rmsnorm(x, p.norm1, cfg.norm_eps)
    attn_out, new_attn = L.attention_decode(p.attn, h, cache["attn"], pos, cfg)
    if cfg.parallel_block:
        x = x + attn_out + L.mlp_apply(p.mlp, h, cfg)
    else:
        x = x + attn_out
        x = x + L.mlp_apply(p.mlp, L.rmsnorm(x, p.norm2, cfg.norm_eps), cfg)
    return x, {"attn": new_attn}


def stack_full(blocks, x, cfg: ModelConfig, *, want_cache=False, total_len=0):
    """Every layer in order; with `want_cache` also the per-layer caches."""
    caches = []
    for p_layer in blocks:
        x, cache = _block_full(p_layer, x, cfg, want_cache=want_cache, total_len=total_len)
        caches.append(cache)
    return x, (caches if want_cache else None)


def _stack_decode(blocks, caches, x, pos: int, cfg: ModelConfig):
    new_caches = []
    for p_layer, cache in zip(blocks, caches, strict=True):
        x, new_cache = _block_decode(p_layer, x, cache, pos, cfg)
        new_caches.append(new_cache)
    return x, new_caches


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> ParamTree:
    """Random parameters from a `torch.Generator` seeded with `seed`, drawn
    on `device` with JAX's distributions (truncated normal, fan-in stds);
    the numbers differ from JAX's for the same seed."""
    require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tree = {"embed": L.init_embed(gen, cfg), "final_norm": L.init_norm(cfg.d_model, dev)}
    tree["blocks"] = [_init_block(gen, cfg) for _ in range(cfg.n_layers)]
    return ParamTree(tree)


def forward(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Full-sequence forward -> final hidden states [B, S, d]."""
    x = L.embed_tokens(params.embed, batch["tokens"], cfg)
    x, _ = stack_full(params.blocks, x, cfg)
    return L.rmsnorm(x, params.final_norm, cfg.norm_eps)


def logits_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    return L.unembed(params.embed, forward(cfg, params, batch), cfg)


def prefill(cfg: ModelConfig, params, batch, total_len: int):
    """Run the full prompt, returning (caches, last-position logits)."""
    x = L.embed_tokens(params.embed, batch["tokens"], cfg)
    x, caches = stack_full(params.blocks, x, cfg, want_cache=True, total_len=total_len)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    return caches, L.unembed(params.embed, x[:, -1:], cfg)


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *, device="cuda") -> list:
    """Zero caches for decode-from-scratch."""
    dev = resolve_device(device)
    return [{"attn": L.init_cache(cfg, batch, seq_len, dev)} for _ in range(cfg.n_layers)]


def decode_step(cfg: ModelConfig, params, caches, token: torch.Tensor, pos: int):
    """One decode step. token: integer [B, 1]; pos: int. Returns (logits
    [B, 1, vocab], caches); the caches are updated in place."""
    x = L.embed_tokens(params.embed, token, cfg)
    x, new_caches = _stack_decode(params.blocks, caches, x, pos, cfg)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    return L.unembed(params.embed, x, cfg), new_caches
