"""Plain PyTorch versions of blockwise (flash) attention with GQA / causal /
sliding window, the CUDA kernel's references (copies of the JAX package's
`kernels/flash_attention/ref.py`).

`attention_ref` materialises the full [B, H, Sq, Sk] score tensor: the test
oracle and the CPU path at small shapes. `attention_chunked` is the
streaming-softmax recurrence of the kernel (running max, denominator and
accumulator over KV chunks, masked scores NEG, running max started at
M_INIT) as a double loop over query and KV chunks: the CPU path on long
sequences, and the plain version the kernel is held against on the card.

The two differ on a row that sees no key at all: `attention_ref`'s softmax
over all-NEG scores is uniform (the row gets the mean of V), while the
recurrence and the kernel leave such a row exactly 0, as the Pallas
kernel does.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30
M_INIT = -1e29


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int | None):
    """[Sq, Sk] bool: key k_pos visible from query q_pos."""
    mask = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def attention_ref(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Kv, Sk, D]
    v: torch.Tensor,  # [B, Kv, Sk, D]
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Softmax attention; q head h attends kv head h // (H // Kv).

    q_offset: absolute position of q[..., 0, :] (for decode/chunked prefill).
    """
    b, h, sq, d = q.shape
    _, kv, sk, _ = k.shape
    group = h // kv
    scale = 1.0 / math.sqrt(d)

    qf = q.float().reshape(b, kv, group, sq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    s = torch.where(_mask(q_pos, k_pos, causal, window), s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


def attention_chunked(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Kv, Sk, D]
    v: torch.Tensor,  # [B, Kv, Sk, D]
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Flash-style streaming softmax, one query chunk against every KV chunk
    in turn: peak intermediate [B, H, q_chunk, kv_chunk] instead of
    [B, H, Sq, Sk]. Every chunk is visited (no skipping); masked scores and
    KV padding carry NEG, so skipped and masked work agree."""
    b, h, sq, d = q.shape
    _, kv, sk, _ = k.shape
    group = h // kv
    scale = 1.0 / math.sqrt(d)
    qc, kc = min(q_chunk, sq), min(kv_chunk, sk)
    out = torch.empty(b, h, sq, d, dtype=q.dtype, device=q.device)
    if sq == 0:
        return out
    for q0 in range(0, sq, qc):
        qf = q[:, :, q0:q0 + qc].float()
        n = qf.shape[2]
        qf = qf.reshape(b, kv, group, n, d)
        q_pos = q_offset + q0 + torch.arange(n, device=q.device)
        m_run = torch.full((b, kv, group, n), M_INIT, device=q.device)
        l_run = torch.zeros(b, kv, group, n, device=q.device)
        acc = torch.zeros(b, kv, group, n, d, device=q.device)
        for k0 in range(0, sk, kc):
            kb, vb = k[:, :, k0:k0 + kc].float(), v[:, :, k0:k0 + kc].float()
            s = torch.einsum("bkgqd,bksd->bkgqs", qf, kb) * scale
            k_pos = k0 + torch.arange(kb.shape[2], device=q.device)
            s = torch.where(_mask(q_pos, k_pos, causal, window), s, NEG)
            m_new = torch.maximum(m_run, s.amax(-1))
            corr = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bksd->bkgqd", p, vb)
            m_run = m_new
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]
        out[:, :, q0:q0 + n] = o.reshape(b, h, n, d).to(q.dtype)
    return out
