"""Mamba-2 / SSD (state-space duality) mixer, arXiv:2405.21060 (the JAX
package's `models/ssm.py`).

Prefill and forward use the chunked dual form: intra-chunk (quadratic,
attention-like) + inter-chunk state passing (a linear recurrence over chunk
boundaries), O(L) memory in sequence length, constant-size decode state.
Decode is the plain SSM recurrence:

    h <- exp(dt*A) h + dt * B x ,   y = C h + D x

Layout: d_inner = expand * d_model, heads of size ssm_head_dim, one B/C group
(ngroups=1), scalar A per head. Gated RMSNorm before the out-projection.
`dt`, `A`, the states and both products of the dual form are float32, as
in the reference. The reference has no kernel here (its products are
einsums), so neither has the port: `ssd_chunked` is plain PyTorch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from ..distributed.act import flatten, on_local_slabs, shard, spec_here, unflatten
from ..obs.trace import span
from .config import ModelConfig
from .layers import _dense_init, _matmul, dtype_of, init_norm, rmsnorm

NEG_INF = -1e30


def init_ssm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    din = cfg.ssm_d_inner
    n = cfg.ssm_state
    nh = cfg.ssm_heads
    cw = cfg.conv_width
    conv_dim = din + 2 * n
    pd = dtype_of(cfg.param_dtype)
    dev = gen.device
    return {
        "in_proj": _dense_init(gen, (d, 2 * din + 2 * n + nh), pd),
        "conv_w": _dense_init(gen, (cw, conv_dim), pd, scale=1.0 / math.sqrt(cw)),
        "conv_b": torch.zeros(conv_dim, dtype=pd, device=dev),
        # A = -exp(A_log) in [-16, -1]
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=dev)),
        "D": torch.ones(nh, dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.full((nh,), 0.01, dtype=torch.float32, device=dev))),
        "ssm_norm": init_norm(din, dev),
        "out_proj": _dense_init(gen, (din, d), pd, scale=1.0 / math.sqrt(din * 2 * cfg.n_layers)),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    din, n = cfg.ssm_d_inner, cfg.ssm_state
    z = zxbcdt[..., :din]
    xs = zxbcdt[..., din:2 * din]
    b_in = zxbcdt[..., 2 * din:2 * din + n]
    c_in = zxbcdt[..., 2 * din + n:2 * din + 2 * n]
    dt = zxbcdt[..., 2 * din + 2 * n:]
    return z, xs, b_in, c_in, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, conv_state=None):
    """Depthwise causal conv. x: [B, L, C], w: [K, C]. Returns (y float32,
    new_state) where the state is the last K-1 inputs (for streaming
    decode).

    The taps, the bias and the SiLU run in float32 and stay there: the
    mixer's only consumers (the SSD products and the D skip) are float32,
    as XLA's fused elementwise chains are in the reference. Rounding to
    bf16 after every step adds noise that 48 layers carry to the logits."""
    k = w.shape[0]
    if conv_state is None:
        pad = x.new_zeros(x.shape[0], k - 1, x.shape[2])
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, L+K-1, C]
    n = x.shape[1]
    wf = w.float()
    y = xp[:, 0:n].float() * wf[0]
    for i in range(1, k):
        y = y + xp[:, i:i + n].float() * wf[i]
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return F.silu(y + bias.float()), new_state


def _gated_norm(p, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """rmsnorm(y * silu(z)) with y float32, the gate and the norm in float32
    and one rounding to the compute dtype at the end (the reference rounds
    y and the gated product to bf16 on the way; XLA's fused chain keeps
    them in float32)."""
    return rmsnorm(y * F.silu(z.float()), p.ssm_norm, cfg.norm_eps).to(dtype_of(cfg.compute_dtype))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., q] -> [..., q, q]: T[i, j] = sum_{k=j+1..i} x[k], -inf above diag."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    t = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    return torch.where(mask, t, NEG_INF)


def ssd_chunked(xs, dt, A, B, C, chunk: int, init_state=None):
    """SSD dual form.

    xs: [b, l, h, p]  dt: [b, l, h]  A: [h]  B, C: [b, l, n]
    Returns (y [b, l, h, p] float32, final_state [b, h, p, n] float32).
    """
    b, l, h, p = xs.shape
    n = B.shape[-1]
    pad = (-l) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    lp = l + pad
    nc = lp // chunk
    q = chunk

    xb = xs.reshape(b, nc, q, h, p).float()
    dtb = dt.reshape(b, nc, q, h).float()
    Bb = B.reshape(b, nc, q, n).float()
    Cb = C.reshape(b, nc, q, n).float()

    dA = dtb * A  # [b, nc, q, h] (negative)
    dA_cs = torch.cumsum(dA, dim=2)

    # 1) intra-chunk (diagonal blocks).
    Lmat = torch.exp(_segsum(dA.transpose(-1, -2)))  # [b, nc, h, q, q]
    scores = torch.einsum("bcqn,bcsn->bcqs", Cb, Bb)
    M = Lmat * scores[:, :, None] * dtb.transpose(-1, -2)[:, :, :, None, :]
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", M, xb)

    # 2) per-chunk input -> end-of-chunk state.
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # [b, nc, q, h]
    states = torch.einsum("bcqn,bcqhp->bchpn", Bb, (decay_states * dtb)[..., None] * xb)

    # 3) inter-chunk recurrence over chunks, each chunk fed the state
    # before it.
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # [b, nc, h]
    s = xs.new_zeros(b, h, p, n, dtype=torch.float32) if init_state is None else init_state.float()
    prev = []
    for c in range(nc):
        prev.append(s)
        s = chunk_decay[:, c, :, None, None] * s + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # [b, nc, h, p, n]

    # 4) contribution of the carried-in state to each position.
    state_decay_out = torch.exp(dA_cs)  # [b, nc, q, h]
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cb, prev_states) * state_decay_out[..., None]

    y = (y_diag + y_off).reshape(b, lp, h, p)[:, :l]
    return y, s


def _ssd(xh, dt, A, B, C, chunk: int, init_state=None):
    """`ssd_chunked`. On DTensors each rank scans its own slab: the scan is
    independent across batch rows and heads, so xs, dt, A and the state
    are split on the batch and the heads as `shard`'s "heads" kind splits
    xs, and B, C (shared by the heads) on the batch alone. DTensor's own
    rules would fold a head split into a batched product's batch dim,
    which some torch releases refuse to view."""
    if not isinstance(xh, DTensor):
        return ssd_chunked(xh, dt, A, B, C, chunk, init_state)
    b, _, h, _ = spec_here(xh.shape, "heads")
    state = (b, h, None, None)
    return on_local_slabs(
        lambda *a: ssd_chunked(*a[:5], chunk, a[5]), (xh, dt, A, B, C, init_state),
        [(b, None, h, None), (b, None, h), (h,), (b, None, None), (b, None, None),
         None if init_state is None else state],
        [(b, None, h, None), state])


def ssm_apply(p, x: torch.Tensor, cfg: ModelConfig, init_state=None):
    """Full-sequence SSD mixer. x: [B, L, d] -> ([B, L, d] output, final
    state, conv input [B, L, conv_dim]); JAX's returns the first two and
    `_ssm_prefill_cache` recomputes the third."""
    cd = dtype_of(cfg.compute_dtype)
    b, l, _ = x.shape
    din, n, nh, hp = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    zxbcdt = shard(_matmul(x, p.in_proj, cd), "ssm_inner")
    z, xs, b_in, c_in, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xs, b_in, c_in], dim=-1)
    conv_out, _ = _causal_conv(conv_in, p.conv_w.to(cd), p.conv_b.to(cd))
    xs = conv_out[..., :din]
    b_in = conv_out[..., din:din + n]
    c_in = conv_out[..., din + n:]

    # jax.nn.softplus is log(1 + exp(x)) everywhere; F.softplus returns x
    # itself above x = 20, where the two differ by under 2.1e-9 (relative
    # 1e-10), far inside every tolerance the port is held to.
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    xh = unflatten(xs, -1, (nh, hp))
    with span("ssm.ssd"):
        y, final_state = _ssd(xh, dt, A, b_in, c_in, cfg.ssm_chunk, init_state)
    y = _gated_norm(p, flatten(y + p.D[:, None] * xh, -2, -1), z, cfg)
    return shard(_matmul(y, p.out_proj, cd), "residual"), final_state, conv_in


def init_ssm_cache(cfg: ModelConfig, batch: int, device) -> dict:
    nh, hp, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.ssm_d_inner + 2 * n
    return {
        "state": torch.zeros(batch, nh, hp, n, dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, cfg.conv_width - 1, conv_dim, dtype=dtype_of(cfg.compute_dtype),
                            device=device),
    }


def ssm_decode(p, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One-token recurrent step. x: [B, 1, d] -> ([B, 1, d], new cache)."""
    cd = dtype_of(cfg.compute_dtype)
    b = x.shape[0]
    din, n, nh, hp = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    zxbcdt = shard(_matmul(x, p.in_proj, cd), "ssm_inner")
    z, xs, b_in, c_in, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xs, b_in, c_in], dim=-1)  # [B, 1, conv_dim]
    conv_out, new_conv = _causal_conv(conv_in, p.conv_w.to(cd), p.conv_b.to(cd), conv_state=cache["conv"])
    xs = conv_out[..., :din]
    b_in = conv_out[..., din:din + n]
    c_in = conv_out[..., din + n:]

    dt = F.softplus(dt.float() + p.dt_bias)[:, 0]  # [B, nh]; softplus as in ssm_apply
    A = -torch.exp(p.A_log)
    dA = torch.exp(dt * A)  # [B, nh]
    xh = xs.reshape(b, nh, hp)
    Bv = b_in[:, 0]  # [B, n]
    Cv = c_in[:, 0]

    state = cache["state"] * dA[:, :, None, None] + (dt[:, :, None] * xh)[..., None] * Bv[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", Cv, state) + p.D[:, None] * xh
    y = _gated_norm(p, y.reshape(b, 1, din), z, cfg)
    return _matmul(y, p.out_proj, cd), {"state": state, "conv": new_conv}
