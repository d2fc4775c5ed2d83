"""Port parity: flash attention (repro_torch.kernels.flash_attention) against
the JAX package's Pallas kernel (interpret mode) and its jnp oracle, on the
same numpy inputs, on the CPU, where the wrapper runs the CUDA kernel's
plain versions.

Tolerances: fp32 atol/rtol 1e-5 (the same fp32 softmax, summed in another
order); bf16 2e-2 (test_kernels.py's bf16 bound: the output is rounded to
bf16 after fp32 arithmetic that differs in summation order).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_chunked as j_chunked
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch.kernels.flash_attention import (
    M_INIT,
    NEG,
    attention_chunked,
    attention_ref,
    flash_attention,
)
from repro_torch.kernels.flash_attention import ops as fa_ops

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

# test_kernels.py's eight cases: (B, H, Kv, Sq, Sk, D, causal, window)
ATTN_CASES = [
    (1, 4, 4, 128, 128, 64, True, None),     # MHA causal
    (2, 8, 2, 256, 256, 64, True, None),     # GQA 4:1
    (1, 8, 1, 128, 128, 128, True, None),    # MQA
    (1, 4, 4, 128, 128, 64, False, None),    # bidirectional (encoder)
    (1, 8, 2, 256, 256, 64, True, 128),      # sliding window
    (2, 4, 2, 100, 100, 64, True, None),     # non-multiple seq (padding)
    (1, 4, 2, 64, 192, 64, True, None),      # Sq != Sk with q_offset
    (1, 2, 2, 128, 128, 256, True, None),    # gemma-style d=256
]


def _inputs(b, h, kv, sq, sk, d, seed, dtype):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, h, sq, d), rng.randn(b, kv, sk, d), rng.randn(b, kv, sk, d)]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = [jnp.asarray(a, jnp.float32).astype(jdt) for a in arrs]
    tx = [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrs]
    return jx, tx


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **(FP32_TOL if dtype == torch.float32 else BF16_TOL))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_port_matches_pallas_and_jnp(case, dtype):
    b, h, kv, sq, sk, d, causal, window = case
    (jq, jk, jv), (q, k, v) = _inputs(b, h, kv, sq, sk, d, 7 + sq + d + h, dtype)
    kw = dict(causal=causal, window=window, q_offset=sk - sq if sq != sk else 0)
    # The interpret-mode Pallas kernel compiles per shape and dtype (seconds
    # each), so the bf16 cases meet it at the first case only and the jnp
    # oracle everywhere.
    wants = [j_ref(jq, jk, jv, **kw)]
    if dtype == torch.float32 or case == ATTN_CASES[0]:
        wants.append(flash_attention_pallas(jq, jk, jv, interpret=True, **kw))
    for got in (
        flash_attention(q, k, v, **kw),
        attention_ref(q, k, v, **kw),
        attention_chunked(q, k, v, q_chunk=48, kv_chunk=40, **kw),
    ):
        assert got.dtype == dtype and got.shape == (b, h, sq, d)
        for want in wants:
            _close(got, want, dtype)


@pytest.mark.parametrize("q_chunk,kv_chunk", [(64, 64), (128, 64), (64, 128), (17, 23)])
def test_chunked_block_boundaries(q_chunk, kv_chunk):
    """Chunks that cross the sequence length, against JAX's streaming path
    and the Pallas kernel at the matching block sizes."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 2, 2, 200, 200, 64, 13, torch.float32)
    got = attention_chunked(q, k, v, causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
    _close(got, j_chunked(jq, jk, jv, causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk), torch.float32)
    _close(got, j_ref(jq, jk, jv, causal=True), torch.float32)
    if q_chunk in (64, 128) and kv_chunk in (64, 128):
        pallas = flash_attention_pallas(jq, jk, jv, causal=True, bq=q_chunk, bk=kv_chunk, interpret=True)
        _close(got, pallas, torch.float32)


def test_fully_masked_rows_are_zero():
    """Rows that see no key (causal, q_offset=-100): exactly 0 in the
    streaming version, as in the Pallas kernel; the materialising oracle's
    softmax over all-NEG scores is uniform instead, in both packages."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 2, 2, 8, 8, 64, 17, torch.float32)
    got = attention_chunked(q, k, v, causal=True, q_offset=-100)
    assert torch.equal(got, torch.zeros_like(got))
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, q_offset=-100, interpret=True)
    assert np.array_equal(np.asarray(pallas), np.zeros(got.shape, np.float32))
    uniform = attention_ref(q, k, v, causal=True, q_offset=-100)
    _close(uniform, j_ref(jq, jk, jv, causal=True, q_offset=-100), torch.float32)
    _close(uniform, v.mean(dim=2, keepdim=True).expand_as(uniform), torch.float32)
    assert NEG == -1e30 and M_INIT == -1e29


def test_cpu_route_follows_jax_threshold(monkeypatch):
    """Without a kernel the CPU wrapper takes attention_ref, and the
    streaming version above _CHUNKED_THRESHOLD, as the JAX package does."""
    calls = []
    monkeypatch.setattr(fa_ops, "attention_ref", lambda *a, **k: calls.append("ref"))
    monkeypatch.setattr(fa_ops, "attention_chunked", lambda *a, **k: calls.append("chunked"))
    monkeypatch.setattr(fa_ops, "_CHUNKED_THRESHOLD", 64 * 64)
    x = torch.zeros(1, 1, 64, 8)
    fa_ops.flash_attention(x, x, x)
    fa_ops.flash_attention(torch.zeros(1, 1, 65, 8), x, x)
    assert calls == ["ref", "chunked"]


def test_strided_views_match_contiguous():
    """The model hands over transposed [B, S, H, D] views; the plain
    versions give the same numbers as on contiguous copies."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(2, 40, 4, 32).astype(np.float32)).transpose(1, 2)
    k = torch.from_numpy(rng.randn(2, 40, 2, 32).astype(np.float32)).transpose(1, 2)
    v = torch.from_numpy(rng.randn(2, 40, 2, 32).astype(np.float32)).transpose(1, 2)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=16)
    _close(flash_attention(q, k, v, window=16), want, torch.float32)
    _close(attention_chunked(q, k, v, window=16, q_chunk=16, kv_chunk=16), want, torch.float32)


@pytest.mark.parametrize(
    "dtype,d,want",
    [(torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
     (torch.bfloat16, 256, "wgmma"), (torch.float32, 64, "cuda_core"), (torch.float32, 128, "cuda_core"),
     (torch.bfloat16, 100, "cuda_core")],
)
def test_variant_by_dtype_and_head_dim(dtype, d, want):
    """bf16 with a head dim that is a multiple of 16 takes the tensor cores;
    fp32 (which would be TF32 there) and other head dims the CUDA cores."""
    assert fa_ops._variant(dtype, d) == want


def _emulate_wgmma(q, k, v, *, causal, window, q_offset, bk):
    """The tensor-core kernel's arithmetic in PyTorch: bf16 operands, fp32
    scores and softmax state over KV tiles of `bk` keys, P rounded to bf16
    before P.V (its one extra rounding point) while the row sum takes the
    unrounded P, output acc / max(l, 1e-30) rounded to bf16."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    group = h // kv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    qf = q.float()
    q_pos = q_offset + torch.arange(sq)
    m = torch.full((b, h, sq), M_INIT)
    l = torch.zeros(b, h, sq)
    acc = torch.zeros(b, h, sq, d)
    for k0 in range(0, sk, bk):
        k_pos = torch.arange(k0, min(k0 + bk, sk))
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + bk]) / d ** 0.5
        ok = torch.ones(sq, len(k_pos), dtype=torch.bool)
        if causal:
            ok &= k_pos[None] <= q_pos[:, None]
        if window is not None:
            ok &= k_pos[None] > q_pos[:, None] - window
        s = torch.where(ok, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        p16 = p.to(torch.bfloat16).float()
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p16, vf[:, :, k0:k0 + bk])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize(
    "case",
    [(2, 4, 4, 256, 256, 64, True, None, 0, 128),     # reduced serve prefill, D <= 128 tiles
     (1, 8, 2, 128, 256, 64, True, 96, 128, 128),     # GQA 4:1, window, q_offset
     (1, 4, 1, 128, 128, 256, True, None, 0, 64)],    # MQA D=256, 64-key tiles
    ids=["prefill", "gqa-window", "mqa-d256"],
)
def test_bf16_p_rounding_within_tolerance(case):
    """P rounded to bf16 before P.V (the tensor-core kernel's design) stays
    within FLASH_BF16_TOL of the Pallas kernel in interpret mode and of
    `attention_chunked`, the plain version the kernel is held against."""
    b, h, kv, sq, sk, d, causal, window, q_offset, bk = case
    (jq, jk, jv), (q, k, v) = _inputs(b, h, kv, sq, sk, d, 29 + d + sq, torch.bfloat16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _emulate_wgmma(q, k, v, bk=bk, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close(got, attention_chunked(q, k, v, **kw), torch.bfloat16)
    _close(got, flash_attention_pallas(jq, jk, jv, interpret=True, **kw), torch.bfloat16)
    # Against fp32 attention on the same bf16 inputs, P's rounding and the
    # output's together stay within one bf16 ulp of the largest output.
    exact = attention_chunked(q.float(), k.float(), v.float(), **kw)
    top = exact.abs().max().item()
    assert (got.float() - exact).abs().max().item() <= 2.0 ** (math.floor(math.log2(top)) - 7)
