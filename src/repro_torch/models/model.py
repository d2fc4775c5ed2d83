"""Model assembly: family-specific blocks, layer stacks, and the public
forward / loss / prefill / decode entry points (the JAX package's
`models/model.py`).

Families: dense, moe (attention + mixture of experts), ssm (Mamba-2),
hybrid (Hymba-style parallel attention + SSM in every block) and encdec
(encoder-decoder with cross attention); dense and encdec archs may carry a
stub modality frontend (`frontend_proj` on precomputed features).
Interleaved hybrids (`hybrid_attn_period >= 1`) are profile-only, as in
the reference: `init_params` raises its ValueError. `loss_fn` is the
training loss (next-token cross entropy, optionally streamed over vocab
chunks by `_chunked_ce`).

Parameters live in a `ParamTree`, an `nn.Module` whose names follow the
JAX leaves: `embed.embed` (+ `embed.lm_head` when untied,
`embed.frontend_proj` with a frontend), `final_norm`, and per layer
`blocks.{l}.norm1`, `blocks.{l}.attn.wq` ... (+ `dec_blocks.{l}...` and
`enc_final_norm` for encdec). Where JAX stacks the layers on axis 0 and
scans over them, the port keeps one child module per layer and loops;
int8 leaves (`quant.py`) are dequantized one layer at a time inside the
loops, as in JAX's scan bodies. The functions run on the device the
parameters live on; `init_params` takes `device=` (default "cuda", which
raises without a GPU). `init_params` and `init_caches` also build on
`meta`: the same shapes and dtypes with no data and nothing drawn, for the
dry run's specs (`launch/steps.py`); every entry point that computes takes
"cuda" or "cpu" only. Parameters are built without gradients (serving);
`trainable` turns them on for training. With `cfg.remat`, a forward under
autograd checkpoints each layer (`torch.utils.checkpoint`, non-reentrant):
the counterpart of JAX's `jax.checkpoint` around each scanned layer.

Batch formats:
  LM families      {"tokens": integer [B, S]}
  frontend archs   {"feats": [B, S, frontend_dim], "labels": integer [B, S]}
                   (the labels only for `loss_fn`)
  encdec           {"feats"|"tokens": encoder input, "dec_tokens": [B, S]}
Decode: a token [B, 1] plus per-layer caches (a list of dicts with "attn"
{"k", "v"}, "ssm" {"state", "conv"}, "cross_k"/"cross_v", where JAX stacks
them) and an integer position.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed import act, vocab
from . import layers as L
from . import ssm as S
from .config import ModelConfig
from .quant import dequantize_params, is_quantized_leaf


class ParamTree(nn.Module):
    """A nested dict of tensors as modules and parameters: a dict becomes a
    child module, a list an `nn.ModuleList`, a tensor a parameter, built
    without a gradient (serving; `trainable` turns gradients on). Modules
    and parameters passed in are shared, not copied."""

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


def trainable(params: ParamTree) -> dict[str, nn.Parameter]:
    """Turn gradients on for every leaf and return the leaves by name.
    int8 leaves are not trained: the reference's `jax.value_and_grad`
    refuses them, and so does this, with a ValueError."""
    if any(is_quantized_leaf(m) for m in params.modules()):
        raise ValueError("trainable: the model holds int8 leaves (quantize_params); "
                         "train the float model and quantize it for serving")
    leaves = dict(params.named_parameters())
    for p in leaves.values():
        p.requires_grad_(True)
    return leaves


# ---------------------------------------------------------------------------
# per-family block init
# ---------------------------------------------------------------------------
def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    d, dev = cfg.d_model, gen.device
    if kind in ("dense", "enc"):
        p = {"norm1": L.init_norm(d, dev), "attn": L.init_attention(gen, cfg)}
        if kind == "enc" or not cfg.parallel_block:
            p["norm2"] = L.init_norm(d, dev)
        p["mlp"] = L.init_mlp(gen, cfg)
        return p
    if kind == "moe":
        return {"norm1": L.init_norm(d, dev), "attn": L.init_attention(gen, cfg),
                "norm2": L.init_norm(d, dev), "moe": L.init_moe(gen, cfg)}
    if kind == "ssm":
        return {"norm1": L.init_norm(d, dev), "ssm": S.init_ssm(gen, cfg)}
    if kind == "hybrid":
        return {"norm1": L.init_norm(d, dev), "attn": L.init_attention(gen, cfg),
                "ssm": S.init_ssm(gen, cfg), "norm_attn_out": L.init_norm(d, dev),
                "norm_ssm_out": L.init_norm(d, dev), "norm2": L.init_norm(d, dev),
                "mlp": L.init_mlp(gen, cfg)}
    if kind == "dec":
        return {"norm1": L.init_norm(d, dev), "self_attn": L.init_attention(gen, cfg),
                "norm_cross": L.init_norm(d, dev), "cross_attn": L.init_attention(gen, cfg),
                "norm2": L.init_norm(d, dev), "mlp": L.init_mlp(gen, cfg)}
    raise ValueError(kind)


def _block_kind(cfg: ModelConfig) -> str:
    if cfg.family == "encdec":
        return "enc"
    return {"dense": "dense", "moe": "moe", "ssm": "ssm", "hybrid": "hybrid"}[cfg.family]


# ---------------------------------------------------------------------------
# cross attention (no RoPE, bidirectional over memory)
# ---------------------------------------------------------------------------
def _cross_attention(p, x, mem_k, mem_v, cfg: ModelConfig):
    """x: [B, S, d]; mem_k/mem_v: [B, Kv, Sm, hd] precomputed from memory.
    Runs the flash wrapper for every query length, the one-token decode
    step included, as JAX does."""
    cd = L.dtype_of(cfg.compute_dtype)
    q = L._project(x, p.wq, getattr(p, "bq", None), cd)
    o = L.flash_attention(q.transpose(1, 2), mem_k, mem_v, causal=False)
    return L._out_proj(p, o.transpose(1, 2), cfg)


def _cross_kv(p, memory, cfg: ModelConfig):
    """Keys and values of the memory, [B, Kv, Sm, hd] (transposed views of
    the [B, Sm, Kv, hd] projections)."""
    cd = L.dtype_of(cfg.compute_dtype)
    k = L._project(memory, p.wk, getattr(p, "bk", None), cd)
    v = L._project(memory, p.wv, getattr(p, "bv", None), cd)
    return k.transpose(1, 2), v.transpose(1, 2)


# ---------------------------------------------------------------------------
# full-sequence block application (forward / prefill)
# ---------------------------------------------------------------------------
def _mlp_residual(p, x, cfg: ModelConfig):
    return x + L.mlp_apply(p.mlp, L.rmsnorm(x, p.norm2, cfg.norm_eps), cfg)


def _block_full(p, x, cfg: ModelConfig, kind: str, *, causal=True, memory=None,
                want_cache=False, total_len=0):
    cache = {}
    if kind in ("dense", "enc", "moe", "hybrid"):
        h = L.rmsnorm(x, p.norm1, cfg.norm_eps)
        attn_out, k_rot, v = L.attention_full(p.attn, h, cfg, causal=causal)
        if want_cache:
            cache["attn"] = L.prefill_cache(k_rot, v, cfg, total_len)
        if kind == "moe":
            x = x + attn_out
            return x + L.moe_apply(p.moe, L.rmsnorm(x, p.norm2, cfg.norm_eps), cfg), cache
        if kind == "hybrid":
            ssm_out, final_state, conv_in = S.ssm_apply(p.ssm, h, cfg)
            if want_cache:
                cache["ssm"] = _ssm_prefill_cache(conv_in, final_state, cfg)
            mixed = 0.5 * (L.rmsnorm(attn_out, p.norm_attn_out, cfg.norm_eps)
                           + L.rmsnorm(ssm_out, p.norm_ssm_out, cfg.norm_eps))
            return _mlp_residual(p, x + mixed, cfg), cache
        if cfg.parallel_block:
            return x + attn_out + L.mlp_apply(p.mlp, h, cfg), cache
        return _mlp_residual(p, x + attn_out, cfg), cache
    if kind == "ssm":
        h = L.rmsnorm(x, p.norm1, cfg.norm_eps)
        y, final_state, conv_in = S.ssm_apply(p.ssm, h, cfg)
        if want_cache:
            cache["ssm"] = _ssm_prefill_cache(conv_in, final_state, cfg)
        return x + y, cache
    if kind == "dec":
        h = L.rmsnorm(x, p.norm1, cfg.norm_eps)
        attn_out, k_rot, v = L.attention_full(p.self_attn, h, cfg, causal=True)
        if want_cache:
            cache["attn"] = L.prefill_cache(k_rot, v, cfg, total_len)
        x = x + attn_out
        hc = L.rmsnorm(x, p.norm_cross, cfg.norm_eps)
        mem_k, mem_v = _cross_kv(p.cross_attn, memory, cfg)
        if want_cache:
            cache["cross_k"], cache["cross_v"] = mem_k, mem_v
        x = x + _cross_attention(p.cross_attn, hc, mem_k, mem_v, cfg)
        return _mlp_residual(p, x, cfg), cache
    raise ValueError(kind)


def _ssm_prefill_cache(conv_in, final_state, cfg: ModelConfig) -> dict:
    """Conv tail (the last conv_width-1 pre-conv channels, from the conv
    input `ssm_apply` computed) + final SSD state."""
    return {"state": final_state, "conv": conv_in[:, -(cfg.conv_width - 1):].contiguous()}


# ---------------------------------------------------------------------------
# decode block application
# ---------------------------------------------------------------------------
def _block_decode(p, x, cache, pos: int, cfg: ModelConfig, kind: str):
    new_cache = {}
    h = L.rmsnorm(x, p.norm1, cfg.norm_eps)
    if kind in ("dense", "moe"):
        attn_out, new_cache["attn"] = L.attention_decode(p.attn, h, cache["attn"], pos, cfg)
        if kind == "moe":
            x = x + attn_out
            return x + L.moe_apply(p.moe, L.rmsnorm(x, p.norm2, cfg.norm_eps), cfg), new_cache
        if cfg.parallel_block:
            return x + attn_out + L.mlp_apply(p.mlp, h, cfg), new_cache
        return _mlp_residual(p, x + attn_out, cfg), new_cache
    if kind == "ssm":
        y, new_cache["ssm"] = S.ssm_decode(p.ssm, h, cache["ssm"], cfg)
        return x + y, new_cache
    if kind == "hybrid":
        attn_out, new_cache["attn"] = L.attention_decode(p.attn, h, cache["attn"], pos, cfg)
        ssm_out, new_cache["ssm"] = S.ssm_decode(p.ssm, h, cache["ssm"], cfg)
        mixed = 0.5 * (L.rmsnorm(attn_out, p.norm_attn_out, cfg.norm_eps)
                       + L.rmsnorm(ssm_out, p.norm_ssm_out, cfg.norm_eps))
        return _mlp_residual(p, x + mixed, cfg), new_cache
    if kind == "dec":
        attn_out, new_cache["attn"] = L.attention_decode(p.self_attn, h, cache["attn"], pos, cfg)
        x = x + attn_out
        hc = L.rmsnorm(x, p.norm_cross, cfg.norm_eps)
        x = x + _cross_attention(p.cross_attn, hc, cache["cross_k"], cache["cross_v"], cfg)
        new_cache["cross_k"], new_cache["cross_v"] = cache["cross_k"], cache["cross_v"]
        return _mlp_residual(p, x, cfg), new_cache
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# stacks (a loop over layers)
# ---------------------------------------------------------------------------
def _layers(blocks, cfg: ModelConfig):
    """The layers in order, each dequantized to the compute dtype when the
    stack is int8. `quantize_params` decides per stacked leaf, so every
    layer of a stack is quantized alike and the first layer decides for
    the call; a float stack is iterated as it is."""
    first = next(iter(blocks), None)
    if first is None or not any(is_quantized_leaf(m) for m in first.modules()):
        return iter(blocks)
    cd = L.dtype_of(cfg.compute_dtype)
    return (dequantize_params(p_layer, cd) for p_layer in blocks)


def stack_full(blocks, x, cfg: ModelConfig, kind: str, *, causal=True, memory=None,
               want_cache=False, total_len=0):
    """Every layer in order; with `want_cache` also the per-layer caches.
    With `cfg.remat`, under autograd and without caches (JAX's prefill
    passes remat=False), each layer is checkpointed: its activations are
    recomputed in the backward pass instead of kept."""
    if cfg.remat and not want_cache and torch.is_grad_enabled():
        # Under activation_sharding the recompute, which may run on
        # autograd's device thread, runs in the same context.
        kw = {"context_fn": lambda: (contextlib.nullcontext(), act.enter_context())} if act.active() else {}
        for p_layer in _layers(blocks, cfg):
            x, _ = checkpoint(_block_full, p_layer, x, cfg, kind, causal=causal, memory=memory,
                              use_reentrant=False, **kw)
        return x, None
    caches = []
    for p_layer in _layers(blocks, cfg):
        x, cache = _block_full(p_layer, x, cfg, kind, causal=causal,
                               memory=memory, want_cache=want_cache, total_len=total_len)
        caches.append(cache)
    return x, (caches if want_cache else None)


def _stack_decode(blocks, caches, x, pos: int, cfg: ModelConfig, kind: str):
    new_caches = []
    for p_layer, cache in zip(_layers(blocks, cfg), caches, strict=True):
        x, new_cache = _block_decode(p_layer, x, cache, pos, cfg, kind)
        new_caches.append(new_cache)
    return x, new_caches


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def _build_device(device) -> torch.device:
    """`meta` as it is (shapes only); any other device as an entry point
    resolves it."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> ParamTree:
    """Random parameters from a `torch.Generator` seeded with `seed`, drawn
    on `device` with JAX's distributions (truncated normal, fan-in stds);
    the numbers differ from JAX's for the same seed. Float leaves, also
    with `quantize_int8` set, as in JAX: `quant.quantize_params` makes the
    int8 tree. On `meta` nothing is drawn (`layers.MetaDraws`)."""
    if cfg.family == "hybrid" and cfg.hybrid_attn_period >= 1:
        raise ValueError(
            f"init_params: {cfg.name!r} declares an interleaved hybrid "
            f"layer mix (hybrid_attn_period={cfg.hybrid_attn_period}) but "
            "the executable substrate only implements parallel hybrid "
            "blocks (attention + SSM every layer); interleaved configs are "
            "profile-only — see partition/profile.py"
        )
    dev = _build_device(device)
    gen = L.MetaDraws() if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    tree = {"embed": L.init_embed(gen, cfg), "final_norm": L.init_norm(cfg.d_model, dev)}
    kind = _block_kind(cfg)
    tree["blocks"] = [_init_block(gen, cfg, kind) for _ in range(cfg.n_layers)]
    if cfg.family == "encdec":
        tree["dec_blocks"] = [_init_block(gen, cfg, "dec") for _ in range(cfg.n_dec_layers)]
        tree["enc_final_norm"] = L.init_norm(cfg.d_model, dev)
    return ParamTree(tree)


def _embed_input(cfg: ModelConfig, params, batch) -> torch.Tensor:
    if cfg.frontend != "none":
        return L.embed_frontend(params.embed, batch["feats"], cfg)
    return L.embed_tokens(params.embed, batch["tokens"], cfg)


def encode(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Encoder stack (encdec family): bidirectional attention -> memory."""
    x = _embed_input(cfg, params, batch)
    x, _ = stack_full(params.blocks, x, cfg, "enc", causal=False)
    return L.rmsnorm(x, params.enc_final_norm, cfg.norm_eps)


def decode_stack(cfg: ModelConfig, params, memory, dec_tokens, *, want_cache=False, total_len=0):
    """The decoder stack over the memory (encdec family), before the final
    norm: (hidden states, caches)."""
    y = L.embed_tokens(params.embed, dec_tokens, cfg)
    return stack_full(params.dec_blocks, y, cfg, "dec", memory=memory,
                      want_cache=want_cache, total_len=total_len)


def forward(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Full-sequence forward -> final hidden states [B, S, d]."""
    if cfg.family == "encdec":
        y, _ = decode_stack(cfg, params, encode(cfg, params, batch), batch["dec_tokens"])
        return L.rmsnorm(y, params.final_norm, cfg.norm_eps)
    x = _embed_input(cfg, params, batch)
    x, _ = stack_full(params.blocks, x, cfg, _block_kind(cfg))
    return L.rmsnorm(x, params.final_norm, cfg.norm_eps)


def logits_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    return L.unembed(params.embed, forward(cfg, params, batch), cfg)


def _targets(cfg: ModelConfig, batch) -> torch.Tensor:
    if cfg.family == "encdec":
        return batch["dec_tokens"][:, 1:]
    if cfg.frontend != "none":
        return batch["labels"][:, 1:]
    return batch["tokens"][:, 1:]


def loss_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Mean next-token cross entropy (fp32 logsumexp, optional vocab
    chunking: a memory knob for the huge-vocab archs)."""
    h = forward(cfg, params, batch)[:, :-1]
    targets = _targets(cfg, batch)
    if cfg.vocab_chunking:
        return _chunked_ce(cfg, params.embed, h, targets)
    logits = L.unembed(params.embed, h, cfg).float()
    if vocab.split(logits, 2):
        return torch.mean(vocab.cross_entropy(logits, targets))
    lse = torch.logsumexp(logits, dim=-1)
    tl = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - tl)


def _chunked_ce(cfg: ModelConfig, embed, h, targets) -> torch.Tensor:
    """Cross entropy without materializing [B, S, V] logits: streams over
    vocab chunks keeping a running logsumexp + the target logit."""
    v, nch = cfg.vocab, cfg.vocab_chunking
    csize = math.ceil(v / nch)
    cd = L.dtype_of(cfg.compute_dtype)
    b, s, _ = h.shape
    t = targets.long()
    lse = torch.full((b, s), -math.inf, dtype=torch.float32, device=h.device)
    tl = torch.zeros((b, s), dtype=torch.float32, device=h.device)
    for c in range(nch):
        lo = c * csize
        hi = min(v, lo + csize)
        w = embed.embed[lo:hi].T if cfg.tie_embeddings else embed.lm_head[:, lo:hi]
        logits_c = torch.matmul(h, w.to(cd)).float()
        lse = torch.logaddexp(lse, torch.logsumexp(logits_c, dim=-1))
        in_chunk = (t >= lo) & (t < hi)
        idx = torch.clamp(t - lo, 0, hi - lo - 1)
        got = torch.gather(logits_c, -1, idx[..., None])[..., 0]
        tl = tl + torch.where(in_chunk, got, 0.0)
    return torch.mean(lse - tl)


def prefill(cfg: ModelConfig, params, batch, total_len: int):
    """Run the full prompt, returning (caches, last-position logits)."""
    if cfg.family == "encdec":
        x, caches = decode_stack(cfg, params, encode(cfg, params, batch), batch["dec_tokens"],
                                 want_cache=True, total_len=total_len)
    else:
        x = _embed_input(cfg, params, batch)
        x, caches = stack_full(params.blocks, x, cfg, _block_kind(cfg), want_cache=True,
                               total_len=total_len)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    return caches, L.unembed(params.embed, x[:, -1:], cfg)


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *, device="cuda") -> list:
    """Zero caches for decode-from-scratch (on `meta`: their shapes)."""
    dev = _build_device(device)
    kind = "dec" if cfg.family == "encdec" else _block_kind(cfg)
    n_layers = cfg.n_dec_layers if cfg.family == "encdec" else cfg.n_layers

    def one_layer():
        c = {}
        if kind in ("dense", "moe", "hybrid", "dec"):
            c["attn"] = L.init_cache(cfg, batch, seq_len, dev)
        if kind in ("ssm", "hybrid"):
            c["ssm"] = S.init_ssm_cache(cfg, batch, dev)
        if kind == "dec":
            shape = (batch, cfg.n_kv_heads, seq_len, cfg.head_dim)
            cd = L.dtype_of(cfg.compute_dtype)
            c["cross_k"] = torch.zeros(shape, dtype=cd, device=dev)
            c["cross_v"] = torch.zeros(shape, dtype=cd, device=dev)
        return c

    return [one_layer() for _ in range(n_layers)]


def decode_step(cfg: ModelConfig, params, caches, token: torch.Tensor, pos: int):
    """One decode step. token: integer [B, 1]; pos: int. Returns (logits
    [B, 1, vocab], caches); attention caches are updated in place."""
    x = L.embed_tokens(params.embed, token, cfg)
    if cfg.family == "encdec":
        x, new_caches = _stack_decode(params.dec_blocks, caches, x, pos, cfg, "dec")
    else:
        x, new_caches = _stack_decode(params.blocks, caches, x, pos, cfg, _block_kind(cfg))
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    return L.unembed(params.embed, x, cfg), new_caches
