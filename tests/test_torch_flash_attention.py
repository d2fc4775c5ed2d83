"""Port parity: flash attention (repro_torch.kernels.flash_attention) against
the JAX package's Pallas kernel (interpret mode) and its jnp oracle, on the
same numpy inputs, on the CPU, where the wrapper runs the CUDA kernel's
plain versions.

Tolerances: fp32 atol/rtol 1e-5 (the same fp32 softmax, summed in another
order); bf16 2e-2 (test_kernels.py's bf16 bound: the output is rounded to
bf16 after fp32 arithmetic that differs in summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
