"""Port parity: weight-only int8 storage (repro_torch.models.quant) against
the JAX package's `models/quant.py` on the CPU.

`quantize_params` must give JAX's int8 values and scales bitwise: the port
keeps one module per layer and decides which leaves to quantize on JAX's
stacked shape (a reduced dense MLP's `wi` is [2, 128, 256] stacked, 65,536
elements and quantized, though a layer holds 32,768), each layer with its
own scale. The quantized models' logits, prefill and decode are held to
JAX's on the same int8 tree at fp32 rtol/atol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from _torch_families import FP32_TOL, batch, configs, j_decode, j_logits, j_prefill, jb, pair, tb, to_np, tokens
from repro.models import quant as j_quant
from repro_torch.configs import reduced_config
from repro_torch.models import decode_step, dequantize_params, init_params, logits_fn, prefill, quantize_params
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.quant import is_quantized_leaf


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-370m", "mixtral-8x22b", "seamless-m4t-medium"])
def test_quantize_params_bitwise_and_logits_match_jax(arch):
    jcfg, tcfg, jp, tp = pair(arch)
    jq = j_quant.quantize_params(jp)
    tq = quantize_params(tp)
    want, got = _flat(jax.tree.map(np.asarray, jq)), _flat(params_to_numpy(tq))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == w.dtype and np.array_equal(got[name], w), name
    assert any(name.endswith("['__q']") for name in want)
    b = batch(jcfg, tokens(jcfg.vocab, 2, 24))
    np.testing.assert_allclose(to_np(logits_fn(tcfg, tq, tb(b))), to_np(j_logits(jcfg, jq, jb(b))), **FP32_TOL)


def test_stacked_size_rule():
    """A reduced dense MLP's `wi`: quantized for its stacked size, one scale
    a layer; the norms ([2, 128] stacked) stay float."""
    tq = quantize_params(init_params(reduced_config("qwen1.5-0.5b"), 0, device="cpu"))
    for layer in tq.blocks:
        wi = layer.mlp.wi
        assert is_quantized_leaf(wi) and getattr(wi, "__q").dtype == torch.int8
        assert getattr(wi, "__s").shape == () and not is_quantized_leaf(layer.norm1)
    assert is_quantized_leaf(tq.embed.embed)  # [512, 128]: 65,536 elements
    assert not torch.equal(getattr(tq.blocks[0].mlp.wi, "__s"), getattr(tq.blocks[1].mlp.wi, "__s"))


def test_quantized_prefill_decode_match_jax():
    """The int8 embedding gather (only the gathered rows dequantized), the
    per-layer dequantization in prefill and decode, and the int8 head."""
    jcfg, tcfg, jp, tp = pair("gemma-2b")
    jq, tq = j_quant.quantize_params(jp), quantize_params(tp)
    toks = tokens(jcfg.vocab, 2, 20)
    jc, jl = j_prefill(jcfg, jq, {"tokens": jnp.asarray(toks[:, :16])}, 32)
    tc, tl = prefill(tcfg, tq, {"tokens": torch.from_numpy(toks[:, :16])}, 32)
    np.testing.assert_allclose(to_np(tl), to_np(jl), **FP32_TOL)
    for pos in range(16, 19):
        jl, jc = j_decode(jcfg, jq, jc, jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos))
        tl, tc = decode_step(tcfg, tq, tc, torch.from_numpy(toks[:, pos:pos + 1]), pos)
        np.testing.assert_allclose(to_np(tl), to_np(jl), **FP32_TOL)


def test_dequantize_and_round_trip_bitwise():
    """JAX's int8 tree -> port -> numpy gives back every int8 value and
    every per-layer scale; `dequantize_params` equals JAX's."""
    jcfg, tcfg, jp, _ = pair("qwen2-moe-a2.7b")
    jq = jax.tree.map(np.asarray, j_quant.quantize_params(jp))
    tq = params_from_jax(tcfg, jq, device="cpu")
    back = _flat(params_to_numpy(tq))
    for name, w in _flat(jq).items():
        assert np.array_equal(back[name], w), name
    want = _flat(jax.tree.map(np.asarray, j_quant.dequantize_params(jq, jnp.float32)))
    got = _flat(params_to_numpy(dequantize_params(tq, torch.float32)))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert np.array_equal(got[name], w), name


def test_init_params_stays_float_with_quantize_int8():
    """As in JAX, the config flag does not quantize at init."""
    _, tcfg = configs("qwen1.5-0.5b", quantize_int8=True)
    params = init_params(tcfg, 0, device="cpu")
    assert all(p.is_floating_point() for p in params.parameters())
    assert dataclasses.replace(tcfg, quantize_int8=False).n_params() == tcfg.n_params()
