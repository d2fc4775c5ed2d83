"""Layer primitives shared by every architecture family (the JAX
package's `models/layers.py`).

Functions over parameter modules whose leaves keep the JAX names and
layouts (per layer):

  attn:  wq [d, H, hd]   wk/wv [d, Kv, hd]   wo [H, hd, d]  (+ optional bq/bk/bv)
  mlp:   wi [d, ff] (+ wg [d, ff] for GLU)   wo [ff, d]
  moe:   router [d, E]   wi_e [E, d, ff] (+ wg_e)   wo_e [E, ff, d]
         (+ shared: an mlp, and shared_gate [d, 1])
  norm:  scale [d]
  embed: embed [vocab, d] (+ lm_head [d, vocab], frontend_proj [F, d])

`shard(x, kind)` (distributed/act.py) marks JAX's activation points: it
returns x untouched without an `activation_sharding` context, and lays a
DTensor out over the mesh under one. Full-sequence attention runs the flash kernel wrapper
(CUDA kernel on the card, plain version on the CPU); decode attention, the
projections, the MoE dispatch and expert products and the unembedding are
plain PyTorch, as they are plain XLA in the JAX package. The embedding
and head leaves may be int8 (`quant.py`): the token gather dequantizes
only the gathered rows.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed import vocab
from ..distributed.act import (
    context,
    flatten,
    grad_in_layout,
    match_layout,
    shard,
    softmax_last,
    spec_here,
    unflatten,
)
from ..kernels.flash_attention import flash_attention
from ..obs.trace import span
from .config import ModelConfig
from .quant import dequantize_leaf, is_quantized_leaf

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
class MetaDraws:
    """Stands in for the generator when parameters are built on `meta`
    (shapes and dtypes only, for the dry run's specs): it names the device
    and nothing is drawn."""

    device = torch.device("meta")


def _dense_init(gen: torch.Generator | MetaDraws, shape, dtype, scale=None) -> torch.Tensor:
    """Truncated normal in [-2, 2] times std (fan-in rule unless `scale`),
    drawn in fp32 on the generator's device, then cast to `dtype`."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if not isinstance(gen, MetaDraws):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


# ---------------------------------------------------------------------------
# norm
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in fp32 with the (1 + scale) convention; output in x's dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def init_norm(d: int, device) -> torch.Tensor:
    return torch.zeros(d, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd], positions: [S] or [B, S] absolute token positions."""
    half = x.shape[-1] // 2
    freq = torch.exp(
        -math.log(theta) * torch.arange(half, dtype=torch.float32, device=x.device) / half
    )  # [half]
    if positions.dim() == 1:
        ang = (positions[:, None].float() * freq[None, :])[None, :, None, :]  # [1, S, 1, half]
    else:
        ang = (positions[..., None].float() * freq)[:, :, None, :]  # [B, S, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pd = dtype_of(cfg.param_dtype)
    p = {
        "wq": _dense_init(gen, (d, h, hd), pd),
        "wk": _dense_init(gen, (d, kv, hd), pd),
        "wv": _dense_init(gen, (d, kv, hd), pd),
        "wo": _dense_init(gen, (h, hd, d), pd, scale=1.0 / math.sqrt(h * hd * 2 * cfg.n_layers)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h, hd, dtype=pd, device=gen.device)
        p["bk"] = torch.zeros(kv, hd, dtype=pd, device=gen.device)
        p["bv"] = torch.zeros(kv, hd, dtype=pd, device=gen.device)
    return p


def _matmul(x: torch.Tensor, w: torch.Tensor, cd) -> torch.Tensor:
    """x @ w in the compute dtype (JAX's einsum over the last dim of x)."""
    return torch.matmul(x, w.to(cd))


def _project(x: torch.Tensor, w: torch.Tensor, bias, cd) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) (+ bias) in the compute dtype."""
    y = unflatten(torch.matmul(x, flatten(w.to(cd), 1, -1)), -1, w.shape[1:])
    return y if bias is None else y + bias.to(cd)


def _qkv(p, x: torch.Tensor, cfg: ModelConfig):
    cd = dtype_of(cfg.compute_dtype)
    q = _project(x, p.wq, getattr(p, "bq", None), cd)
    k = _project(x, p.wk, getattr(p, "bk", None), cd)
    v = _project(x, p.wv, getattr(p, "bv", None), cd)
    return shard(q, "heads"), shard(k, "heads"), shard(v, "heads")


def _out_proj(p, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", o, wo) in the compute dtype."""
    cd = dtype_of(cfg.compute_dtype)
    return torch.matmul(flatten(o, -2, -1), flatten(p.wo.to(cd), 0, 1))


def attention_full(p, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True):
    """Full-sequence attention (prefill / forward; `causal=False` for the
    encoder), x: [B, S, d] -> ([B, S, d]
    output, rotated keys [B, S, Kv, hd], values [B, S, Kv, hd]); JAX's
    returns the output alone and `prefill_cache` recomputes the other two.

    The kernel sees JAX's [B, H, S, hd] layout as transposed views of the
    [B, S, H, hd] projections (it takes strides), and writes its output in
    the same layout, so the transpose back is free. JAX's "heads_t"
    constraint applies to those views."""
    q, k, v = _qkv(p, x, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    qt, kt, vt = (shard(t.transpose(1, 2), "heads_t") for t in (q, k, v))
    o = flash_attention(qt, kt, vt, causal=causal, window=cfg.sliding_window)
    o = shard(o, "heads_t").transpose(1, 2)
    return shard(_out_proj(p, o, cfg), "residual"), k, v


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """KV ring-buffer length: bounded by the sliding window when present."""
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    c = cache_len(cfg, seq_len)
    cd = dtype_of(cfg.compute_dtype)
    shape = (batch, cfg.n_kv_heads, c, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cd, device=device),
            "v": torch.zeros(shape, dtype=cd, device=device)}


def prefill_cache(k_rot: torch.Tensor, v: torch.Tensor, cfg: ModelConfig, seq_len_total: int) -> dict:
    """The ring cache left by a prefill, from the rotated keys and the values
    [B, S, Kv, hd] that `attention_full` computed.

    For ring slot i (cache length C, prefill length S): the slot holds the
    key of absolute position t_i = S-1 - ((S-1-i) mod C), matching the
    decode-time write rule slot(t) = t mod C. Slots not yet written
    (t_i < 0, when the prefill is shorter than the cache) hold the clamped
    position 0's data, as JAX's clipping gather does; decode masks them out
    via abs_pos >= 0.
    """
    s = k_rot.shape[1]
    c = cache_len(cfg, seq_len_total)
    slot = torch.arange(c, device=k_rot.device)
    t_i = ((s - 1) - torch.remainder(s - 1 - slot, c)).clamp(0, s - 1)
    return {
        "k": k_rot.index_select(1, t_i).transpose(1, 2).contiguous(),
        "v": v.index_select(1, t_i).transpose(1, 2).contiguous(),
    }


def attention_decode(p, x: torch.Tensor, cache: dict, pos: int, cfg: ModelConfig):
    """One-token decode. x: [B, 1, d]; cache k/v: [B, Kv, C, hd]; pos int.

    The cache is a ring buffer (slot = pos mod C); RoPE is applied at write
    time with absolute positions, and masking reconstructs each slot's
    absolute position as abs_i = pos - ((pos - i) mod C). Where JAX's
    dynamic_update_slice returns a new cache, the port writes the new key
    and value into the caller's cache tensors in place and returns the same
    dict: a caller that needs the old cache keeps a copy.
    """
    cd = dtype_of(cfg.compute_dtype)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    group = h // kv
    q, k, v = _qkv(p, x, cfg)  # [B, 1, *, hd]
    pos_arr = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q = rope(q, pos_arr, cfg.rope_theta)
    k = rope(k, pos_arr, cfg.rope_theta)

    kc, vc = cache["k"], cache["v"]
    c = kc.shape[2]
    slot = pos % c
    _ring_write(kc, k[:, 0], slot)
    _ring_write(vc, v[:, 0], slot)
    kc, vc = shard(kc, "kv_cache"), shard(vc, "kv_cache")

    idx = torch.arange(c, device=x.device)
    abs_pos = pos - torch.remainder(pos - idx, c)  # in [pos - C + 1, pos]
    valid = abs_pos >= 0
    if cfg.sliding_window is not None:
        valid &= abs_pos > pos - cfg.sliding_window

    qg = match_layout(unflatten(q[:, 0], 1, (kv, group)), kc, 2).float()  # [B, Kv, G, hd]
    scores = shard(torch.einsum("bkgd,bkcd->bkgc", qg, kc.float()) / math.sqrt(hd), "decode_scores")
    scores = torch.where(valid, scores, -1e30)
    w = softmax_last(scores)
    o = torch.einsum("bkgc,bkcd->bkgd", w, vc.float()).to(cd)
    return shard(_out_proj(p, flatten(o, 1, 2).unsqueeze(1), cfg), "residual"), cache


def _ring_write(cache: torch.Tensor, row: torch.Tensor, slot: int) -> None:
    """cache[:, :, slot] = row, in place (cache [B, Kv, C, hd], row
    [B, Kv, hd]). A DTensor cache split on C over some mesh dims (the
    "seq" layout) is written rank by rank, as the SPMD partitioner writes
    JAX's dynamic_update_slice: the row is laid out as the cache is, less
    the C split, and the ranks whose C range holds the slot write it into
    their local cache."""
    if not isinstance(cache, DTensor):
        cache[:, :, slot].copy_(row)
        return
    mesh, pl = cache.device_mesh, cache.placements
    row_pl = [Replicate() if p == Shard(2) else Shard(p.dim - (p.dim > 2)) if isinstance(p, Shard) else p
              for p in pl]
    local_row = row.redistribute(mesh, row_pl).to_local()
    lo, size = 0, cache.shape[2]  # this rank's C range, split in mesh order
    for i, p in enumerate(pl):
        if p == Shard(2):
            n, r = mesh.size(i), mesh.get_local_rank(i)
            size //= n  # `cache_pspecs` splits C only where the split is even
            lo += r * size
    if lo <= slot < lo + size:
        cache.to_local()[:, :, slot - lo].copy_(local_row)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------
def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def _act(name: str):
    acts = {"swiglu": F.silu, "geglu": _gelu_tanh, "relu2": _relu2, "gelu": _gelu_tanh}
    if name not in acts:
        raise ValueError(name)
    return acts[name]


def is_glu(name: str) -> bool:
    return name in ("swiglu", "geglu")


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    pd = dtype_of(cfg.param_dtype)
    p = {
        "wi": _dense_init(gen, (d, ff), pd),
        "wo": _dense_init(gen, (ff, d), pd, scale=1.0 / math.sqrt(ff * 2 * cfg.n_layers)),
    }
    if is_glu(cfg.mlp_act):
        p["wg"] = _dense_init(gen, (d, ff), pd)
    return p


def _glu(act, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """act(g) * h in float32, rounded once to h's dtype: XLA fuses the
    reference's chain in float32 where PyTorch would round act(g) first."""
    return (act(g.float()) * h).to(h.dtype)


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    act = _act(cfg.mlp_act)
    h = shard(_matmul(x, p.wi, cd), "ffn")
    if is_glu(cfg.mlp_act):
        h = _glu(act, shard(_matmul(x, p.wg, cd), "ffn"), h)
    else:
        h = act(h)
    return shard(_matmul(h, p.wo, cd), "residual")


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based dispatch, capacity-dropped, GShard-style)
# ---------------------------------------------------------------------------
def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    pd = dtype_of(cfg.param_dtype)
    p = {
        "router": _dense_init(gen, (d, e), pd, scale=0.02),
        "wi_e": _dense_init(gen, (e, d, ff), pd, scale=1.0 / math.sqrt(d)),
        "wo_e": _dense_init(gen, (e, ff, d), pd, scale=1.0 / math.sqrt(ff * 2 * cfg.n_layers)),
    }
    if is_glu(cfg.mlp_act):
        p["wg_e"] = _dense_init(gen, (e, d, ff), pd, scale=1.0 / math.sqrt(d))
    if cfg.shared_d_ff:
        p["shared"] = init_mlp(gen, cfg, d_ff=cfg.shared_d_ff)
        p["shared_gate"] = _dense_init(gen, (d, 1), pd, scale=0.02)
    return p


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    return max(4, math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def _moe_dispatch_combine(p, xf: torch.Tensor, cfg: ModelConfig, cap: int, first_expert: int = 0) -> torch.Tensor:
    """One dispatch group: xf [T, d] -> [T, d].

    Sort-based dispatch into per-expert capacity buffers (overflow dropped),
    batched expert GEMMs, weighted combine. Router softmax over the selected
    top-k (Mixtral convention).

    The top k is a stable descending sort: `jax.lax.top_k` puts the lower
    expert first on ties, which `torch.topk` does not promise, and bf16
    router logits tie often. Dropped entries go to one spare buffer row
    (JAX's out-of-range row under mode="drop"), which is discarded. The
    combine gathers each token's k contributions and adds them in ascending
    expert order, the order of JAX's scatter-add over the sorted entries,
    with no atomics: the result repeats bitwise.

    The expert weights may hold a slice of the experts or of ff, as one
    rank of a mesh holds them (`_moe_on_mesh`): experts
    [first_expert, first_expert + wi_e.shape[0]) or all E experts' ff
    columns [lo, hi). The routing is always over all E experts, so the drop
    set is the whole layer's; only the held experts' buffers are filled and
    multiplied, and the output is this slice's share of the sum (the whole
    sum when the weights are whole)."""
    cd = dtype_of(cfg.compute_dtype)
    e, k = cfg.n_experts, cfg.top_k
    e_here = p.wi_e.shape[0]
    t, d = xf.shape
    dev = xf.device
    with span("moe.dispatch"):
        logits = _matmul(xf, p.router, cd).float()
        top_logits, top_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        top_w = torch.softmax(top_logits[:, :k], dim=-1)  # [T, k]
        flat_e = top_idx[:, :k].reshape(t * k)
        flat_w = top_w.reshape(t * k)
        sorted_e, order = torch.sort(flat_e, stable=True)
        first_of_group = torch.searchsorted(sorted_e, sorted_e, side="left")
        pos_in_e = torch.arange(t * k, device=dev) - first_of_group
        keep = pos_in_e < cap
        if e_here < e:  # only the held experts' entries land
            keep = keep & (sorted_e >= first_expert) & (sorted_e < first_expert + e_here)
        # e_here * cap: the drop row
        buf_idx = torch.where(keep, (sorted_e - first_expert) * cap + pos_in_e, e_here * cap)
        token_of = order // k
        xbuf = xf.new_zeros(e_here * cap + 1, d).index_copy_(0, buf_idx, xf[token_of])
        xbuf = xbuf[:e_here * cap].view(e_here, cap, d)
    with span("moe.experts"):
        act = _act(cfg.mlp_act)
        h = torch.bmm(xbuf, p.wi_e.to(cd))
        if hasattr(p, "wg_e"):
            h = _glu(act, torch.bmm(xbuf, p.wg_e.to(cd)), h)
        else:
            h = act(h)
        ybuf = torch.bmm(h, p.wo_e.to(cd)).view(e_here * cap, d)
    with span("moe.combine"):
        gathered = ybuf[torch.clamp_max(buf_idx, e_here * cap - 1)]
        contrib = gathered * (flat_w[order] * keep).to(cd)[:, None]
        # slot_of[i]: where flat entry i (token i // k) landed in the sort.
        slot_of = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=dev))
        per_token = contrib[slot_of.view(t, k).sort(dim=-1).values]  # [T, k, d], experts ascending
        out = per_token[:, 0]
        for j in range(1, k):
            out = out + per_token[:, j]
    return out


def _moe_on_mesh(p, x: DTensor, cfg: ModelConfig, groups: int, cap: int) -> DTensor:
    """`moe_apply`'s groups on a mesh: x [B, S, d] -> the combined
    [B, S, d] in the "residual" layout.

    One local region. The tokens are laid out as JAX's "moe_groups"
    constraint lays out the [G, Tg, d] slab: split over the batch axes
    where they divide G (on B, or on S for a batch of one), else
    replicated, and replicated over "model". The router is gathered whole,
    each expert weight to its compute layout (d gathered over the FSDP
    axis, E or ff left split over "model" as the parameter rules split
    it), both cast to the compute dtype first, and every rank runs
    `_moe_dispatch_combine` on its own groups as plain tensors; every
    reshape is of local tensors. Every rank of a data
    shard routes its groups whole, so the drop set is the one process's for
    the same `cfg.moe_groups`; with E split a rank fills and multiplies its
    own experts' buffers, with ff split its ff columns. The result is a
    partial sum over "model" where the experts are split there, which
    `shard` reduces: one all-reduce a layer. The gradients taken back out
    of the region are partial sums over the axes whose ranks saw other
    tokens or other experts; the redistributes back to the parameters'
    layouts reduce them (the FSDP reduce-scatter)."""
    mesh, rules = context()
    names = mesh.mesh_dim_names
    mi = names.index(rules.model_axis)
    b, s, d = x.shape
    tg = b * s // groups
    axes = spec_here((groups, tg, d), "moe_groups")[0] or ()
    axes = (axes,) if isinstance(axes, str) else axes
    nb = math.prod(mesh.size(names.index(a)) for a in axes)
    if b % nb and b > 1:
        axes = ()  # the groups' tokens are no block of B or of S: every rank runs them all
    split = {names.index(a) for a in axes}
    tok = Shard(0 if b % nb == 0 else 1)
    on_model = p.wi_e.placements[mi]  # Shard(0): E over "model"; Shard on ff; or Replicate
    partial = isinstance(on_model, Shard)
    rep = Replicate()
    x_pl = [tok if i in split else rep for i in range(mesh.ndim)]
    out_pl = [tok if i in split else Partial() if i == mi and partial else rep for i in range(mesh.ndim)]
    cd = dtype_of(cfg.compute_dtype)

    def weight(w):  # cast, then gathered in the compute dtype, as DTensor gathers a dense weight
        fwd = [pl if i == mi else rep for i, pl in enumerate(w.placements)]
        grad = [Partial() if i in split else pl for i, pl in enumerate(fwd)]
        return w.to(cd).redistribute(mesh, fwd).to_local(grad_placements=grad)

    local = {n: weight(getattr(p, n)) for n in ("wi_e", "wg_e", "wo_e") if hasattr(p, n)}
    local["router"] = p.router.to(cd).redistribute(mesh, [rep] * mesh.ndim).to_local(
        grad_placements=[Partial() if i in split or (i == mi and partial) else rep for i in range(mesh.ndim)])
    first = mesh.get_local_rank(mi) * local["wi_e"].shape[0] if on_model == Shard(0) else 0
    lp = SimpleNamespace(**local)
    xl = x.redistribute(mesh, x_pl).to_local(grad_placements=out_pl)
    xg = xl.reshape(-1, tg, d)
    out = torch.stack([_moe_dispatch_combine(lp, xg[g], cfg, cap, first) for g in range(xg.shape[0])])
    return shard(DTensor.from_local(out.reshape(xl.shape), mesh, out_pl, run_check=False), "residual")


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d].

    Dispatch runs per group (`cfg.moe_groups`; 0 or 1 is one group, and a
    token count the groups do not divide falls back to one group, as in
    JAX): each group routes its own tokens into its own capacity buffers.
    A qwen2-moe-style shared expert adds its sigmoid-gated MLP.

    On a mesh (`activation_sharding`) each rank dispatches its own groups
    on local tensors and the expert products run in the parameter rules'
    layouts (`_moe_on_mesh`), as JAX's SPMD partitioner runs its vmapped
    dispatch; the shared expert runs on DTensors as the dense MLP does."""
    b, s, d = x.shape
    t = b * s
    groups = max(1, cfg.moe_groups)
    if t % groups != 0:
        groups = 1
    tg = t // groups
    cap = moe_capacity(cfg, tg)
    if isinstance(x, DTensor):
        out = _moe_on_mesh(p, x, cfg, groups, cap)
    else:
        xg = x.reshape(groups, tg, d)
        out = torch.stack([_moe_dispatch_combine(p, xg[g], cfg, cap) for g in range(groups)]).reshape(b, s, d)
    if hasattr(p, "shared"):
        cd = dtype_of(cfg.compute_dtype)
        gate = torch.sigmoid(_matmul(x, p.shared_gate, cd).float()).to(cd)
        out = out + gate * mlp_apply(p.shared, x, cfg)
    return out


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def init_embed(gen: torch.Generator, cfg: ModelConfig) -> dict:
    pd = dtype_of(cfg.param_dtype)
    p = {"embed": _dense_init(gen, (cfg.vocab, cfg.d_model), pd, scale=0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _dense_init(gen, (cfg.d_model, cfg.vocab), pd)
    if cfg.frontend != "none":
        p["frontend_proj"] = _dense_init(gen, (cfg.frontend_dim, cfg.d_model), pd)
    return p


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gather then cast: equal to JAX's cast-then-gather, without casting
    the whole table on every call. An int8 table is gathered as int8 and
    only the gathered rows are dequantized. A DTensor table split on the
    vocab is looked up rank by rank (`distributed.vocab.embedding`)."""
    cd = dtype_of(cfg.compute_dtype)
    table = p.embed
    if is_quantized_leaf(table):
        x = (getattr(table, "__q")[tokens].float() * getattr(table, "__s")).to(cd)
    elif vocab.split(table, 0):
        x = vocab.embedding(tokens, table).to(cd)
    else:
        x = F.embedding(tokens, grad_in_layout(table)).to(cd)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cd)
    return shard(x, "residual")


def _weight(w, cd) -> torch.Tensor:
    """A float or int8 leaf in the compute dtype."""
    return dequantize_leaf(w, cd) if is_quantized_leaf(w) else w.to(cd)


def embed_frontend(p, feats: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Stub modality frontend: precomputed patch/frame embeddings [B, S, F]
    through the learned projector to [B, S, d]."""
    cd = dtype_of(cfg.compute_dtype)
    return shard(torch.matmul(feats.to(cd), _weight(p.frontend_proj, cd)), "residual")


def unembed(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    if not cfg.tie_embeddings:
        w = _weight(p.lm_head, cd)
    elif vocab.split(p.embed, 0):
        w = _weight(p.embed, cd).T
    else:  # the lookup's gradient is re-laid alike (`embed_tokens`)
        w = _weight(grad_in_layout(p.embed), cd).T
    return shard(torch.matmul(x, w), "logits")
