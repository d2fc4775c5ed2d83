"""Port parity: the Mamba-2 / SSD mixer (repro_torch.models.ssm) and the
ssm family (mamba2-370m, reduced) against the JAX package on the CPU: the
dual form, the mixer and its recurrent decode step, the model's logits,
prefill and decode, the executor's split, and the serve loop's tokens.

Inputs are numpy from a seed. Tolerances: fp32 rtol/atol 1e-4 (the same
arithmetic in another summation order; harness doc in _torch_families.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from _torch_families import (
    FP32_TOL,
    check_executor,
    check_logits_prefill_decode,
    check_serve_tokens,
    pair,
    to_np,
)
from repro.models import ssm as j_ssm
from repro_torch.models import ssm as t_ssm


def _ssd_inputs(seed, b=2, l=21, h=3, p=4, n=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, l, h, p).astype(np.float32), rng.uniform(0.01, 0.3, (b, l, h)).astype(np.float32),
            -rng.uniform(0.5, 4.0, (h,)).astype(np.float32), rng.randn(b, l, n).astype(np.float32),
            rng.randn(b, l, n).astype(np.float32), rng.randn(b, h, p, n).astype(np.float32))


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_chunked_matches_jax(chunk):
    """A length (21) no chunk divides, with and without a carried-in state."""
    xs, dt, A, B, C, s0 = _ssd_inputs(chunk)
    for init in (None, s0):
        jy, js = j_ssm.ssd_chunked(*map(jnp.asarray, (xs, dt, A, B, C)), chunk,
                                   None if init is None else jnp.asarray(init))
        ty, ts = t_ssm.ssd_chunked(*map(torch.from_numpy, (xs, dt, A, B, C)), chunk,
                                   None if init is None else torch.from_numpy(init))
        assert ty.shape == xs.shape and ts.shape == s0.shape
        np.testing.assert_allclose(to_np(ty), to_np(jy), **FP32_TOL)
        np.testing.assert_allclose(to_np(ts), to_np(js), **FP32_TOL)


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssm_apply_and_decode_match_jax(chunk):
    """The mixer of layer 0 over 21 tokens (output, final state, and the
    conv tail the prefill cache keeps), then three recurrent steps from that
    cache, each against JAX's."""
    jcfg, tcfg, jp, tp = pair("mamba2-370m", ssm_chunk=chunk)
    j_layer = jax.tree.map(lambda a: a[0], jp["blocks"]["ssm"])
    t_layer = tp.blocks[0].ssm
    x = np.random.RandomState(chunk).randn(2, 24, jcfg.d_model).astype(np.float32)
    jy, jstate = j_ssm.ssm_apply(j_layer, jnp.asarray(x[:, :21]), jcfg)
    ty, tstate, conv_in = t_ssm.ssm_apply(t_layer, torch.from_numpy(x[:, :21]), tcfg)
    np.testing.assert_allclose(to_np(ty), to_np(jy), **FP32_TOL)
    np.testing.assert_allclose(to_np(tstate), to_np(jstate), **FP32_TOL)
    assert conv_in.shape == (2, 21, jcfg.ssm_d_inner + 2 * jcfg.ssm_state)
    tail = conv_in[:, -(jcfg.conv_width - 1):]
    jc = {"state": jstate, "conv": jnp.asarray(to_np(tail))}
    tc = {"state": tstate, "conv": tail}
    for pos in range(21, 24):
        jy, jc = j_ssm.ssm_decode(j_layer, jnp.asarray(x[:, pos:pos + 1]), jc, jcfg)
        ty, tc = t_ssm.ssm_decode(t_layer, torch.from_numpy(x[:, pos:pos + 1]), tc, tcfg)
        np.testing.assert_allclose(to_np(ty), to_np(jy), **FP32_TOL)
        np.testing.assert_allclose(to_np(tc["state"]), to_np(jc["state"]), **FP32_TOL)
        np.testing.assert_allclose(to_np(tc["conv"]), to_np(jc["conv"]), **FP32_TOL)


def test_mamba2_logits_prefill_decode_match_jax():
    check_logits_prefill_decode("mamba2-370m", "float32", FP32_TOL)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_mamba2_executor_matches_monolithic_and_jax(k):
    check_executor("mamba2-370m", k)


def test_mamba2_serve_tokens_match_jax_greedy_oracle():
    check_serve_tokens("mamba2-370m")
