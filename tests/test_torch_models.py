"""Port parity: the dense model substrate (repro_torch.models) against the
JAX package's models on the same weights (`params_from_jax`) and the same
numpy tokens, on the CPU (flash attention through its plain versions).

Tolerances: fp32 compute rtol/atol 1e-4 (the same arithmetic summed in
another order; measured <= 3e-6). bf16 compute: JAX's own prefill-vs-forward
tolerance, rtol 2e-3 and atol 1e-2 (test_models.py), where one bf16 ulp at
a logit of magnitude ~1 is 4e-3-8e-3 and the two frameworks round at
different places (XLA fuses elementwise chains in fp32; PyTorch rounds each
op). nemotron-4-15b's untied head gives logits up to 3.5, where one ulp is
1.6e-2: its measured bf16 error is 3.1e-2 (two ulps), so it is held to
atol 4e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro import models as jm
from repro.configs import ZOO as J_ZOO
from repro.configs import get_config as j_get
from repro.configs import reduced_config as j_reduced
from repro.partition import run_partition as j_run_partition
from repro.partition import split_params as j_split
from repro_torch.configs import ARCHS, ZOO, get_config, reduced_config
from repro_torch.launch.steps import serve_config
from repro_torch.models import decode_step, init_params, logits_fn, prefill
from repro_torch.models.layers import dtype_of
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.partition import run_partition, split_params

MODEL_ARCHS = ["qwen1.5-0.5b", "gemma-2b", "command-r-plus-104b", "nemotron-4-15b"]
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = {"nemotron-4-15b": dict(rtol=2e-3, atol=4e-2)}
JAX_BF16_TOL = dict(rtol=2e-3, atol=1e-2)

# The JAX side, jitted once per config (eager calls recompile their layer
# scans on every call).
j_init = jm.init_params
j_logits = jax.jit(jm.logits_fn, static_argnums=0)
j_prefill = jax.jit(jm.prefill, static_argnums=(0, 3))
j_decode = jax.jit(jm.decode_step, static_argnums=0)


def _configs(arch, compute_dtype, **kw):
    jcfg = dataclasses.replace(j_reduced(arch), compute_dtype=compute_dtype, **kw)
    tcfg = dataclasses.replace(reduced_config(arch), compute_dtype=compute_dtype, **kw)
    return jcfg, tcfg


def _pair(arch, compute_dtype="float32", seed=0, **kw):
    jcfg, tcfg = _configs(arch, compute_dtype, **kw)
    jp = j_init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _tokens(vocab, b, s, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_logits_prefill_decode_match_jax(arch, compute_dtype):
    jcfg, tcfg, jp, tp = _pair(arch, compute_dtype)
    tol = FP32_TOL if compute_dtype == "float32" else BF16_TOL.get(arch, JAX_BF16_TOL)
    toks = _tokens(jcfg.vocab, 2, 24)
    b, t_pre, total = 2, 17, 64
    want = j_logits(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got = logits_fn(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (b, 24, tcfg.vocab) and got.dtype == dtype_of(compute_dtype)
    np.testing.assert_allclose(_np(got), _np(want), **tol)

    jc, jl = j_prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :t_pre])}, total)
    tc, tl = prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :t_pre])}, total)
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    assert len(tc) == tcfg.n_layers and tc[0]["attn"]["k"].shape == (b, tcfg.n_kv_heads, total, tcfg.head_dim)
    # Keys and values are bf16 activations of magnitude ~2 under bf16
    # compute (two ulps = 3e-2): held to the flash tests' bf16 bound.
    cache_tol = FP32_TOL if compute_dtype == "float32" else dict(rtol=2e-2, atol=3e-2)
    for layer in range(tcfg.n_layers):
        for kv in ("k", "v"):
            np.testing.assert_allclose(_np(tc[layer]["attn"][kv]), _np(jc["attn"][kv][layer]), **cache_tol)
    for pos in range(t_pre, t_pre + 5):
        tok = toks[:, pos:pos + 1]
        jl, jc = j_decode(jcfg, jp, jc, jnp.asarray(tok), jnp.int32(pos))
        tl, tc = decode_step(tcfg, tp, tc, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(_np(tl), _np(jl), **tol)
        np.testing.assert_allclose(_np(tl[:, 0]), _np(got[:, pos]), **tol)


def test_decode_past_ring_buffer_wrap():
    """Reduced qwen with a 32-token window, decoded past the ring-buffer
    wrap: every step equals JAX's decode and the port's windowed forward."""
    jcfg, tcfg, jp, tp = _pair("qwen1.5-0.5b", sliding_window=32)
    t_pre, total = 30, 48
    toks = _tokens(jcfg.vocab, 1, total, seed=3)
    jc, _ = j_prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :t_pre])}, total)
    tc, _ = prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :t_pre])}, total)
    assert tc[0]["attn"]["k"].shape[2] == 32
    full = logits_fn(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(full), _np(j_logits(jcfg, jp, {"tokens": jnp.asarray(toks)})), **FP32_TOL)
    for pos in range(t_pre, total - 1):  # crosses slot 32's wraparound
        tok = toks[:, pos:pos + 1]
        jl, jc = j_decode(jcfg, jp, jc, jnp.asarray(tok), jnp.int32(pos))
        tl, tc = decode_step(tcfg, tp, tc, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(_np(tl), _np(jl), **FP32_TOL)
        np.testing.assert_allclose(_np(tl[:, 0]), _np(full[:, pos]), **FP32_TOL)


@pytest.mark.parametrize("arch", J_ZOO)
def test_configs_match_jax(arch):
    """Every config and its reduced form carry JAX's fields (less the
    Pallas switch the port does not have) and derived counts."""
    assert ZOO == J_ZOO
    for port, ref in ((get_config(arch), j_get(arch)), (reduced_config(arch), j_reduced(arch))):
        want = dataclasses.asdict(ref)
        want.pop("use_pallas_attention")
        assert dataclasses.asdict(port) == want
        assert port.n_params() == ref.n_params() and port.n_active_params() == ref.n_active_params()
        assert [port.layer_mix(i) for i in range(port.n_layers)] == [ref.layer_mix(i) for i in range(ref.n_layers)]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_layout_and_distribution(arch):
    """Same leaves, shapes and dtypes as JAX's init (layers stacked back),
    the same analytic parameter count, and per-leaf std within 10%, for
    every executable arch (MoE experts, SSM leaves, decoder blocks and
    frontend projectors included)."""
    cfg = serve_config(reduced_config(arch)) if arch == "qwen1.5-0.5b" else reduced_config(arch)
    jcfg = dataclasses.replace(j_reduced(arch), param_dtype=cfg.param_dtype)
    model = init_params(cfg, 0, device="cpu")
    jax_leaves = dict(_leaves(jax.tree.map(np.asarray, j_init(jcfg, jax.random.PRNGKey(0)))))
    port_leaves = dict(_leaves(params_to_numpy(model)))
    assert port_leaves.keys() == jax_leaves.keys()
    for name, want in jax_leaves.items():
        got = port_leaves[name]
        assert got.shape == want.shape, name
        w = want.astype(np.float32)
        if w.std() == 0:
            assert np.all(got == w), name  # zero norms and biases
        else:
            assert abs(got.std() / w.std() - 1) < 0.1, (name, got.std(), w.std())
    for name, p in model.named_parameters():
        parts = name.split(".")
        leaf = ".".join([parts[0]] + parts[2:]) if parts[0] in ("blocks", "dec_blocks") else name
        assert str(p.dtype).removeprefix("torch.") == jax_leaves[leaf].dtype.name, name
    assert cfg.n_params() == jcfg.n_params()


def test_params_round_trip():
    """JAX tree -> port -> numpy tree gives back every value, bf16 included."""
    jcfg, tcfg = _configs("gemma-2b", "bfloat16", param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, j_init(jcfg, jax.random.PRNGKey(5)))
    tp = params_from_jax(tcfg, tree, device="cpu")
    assert tp.blocks[1].attn.wq.dtype == torch.bfloat16 and tp.blocks[0].norm1.dtype == torch.float32
    back = dict(_leaves(params_to_numpy(tp)))
    for name, want in _leaves(tree):
        assert np.array_equal(back[name], want.astype(np.float32)), name


@pytest.mark.parametrize("k", [0, 1, 2])
def test_executor_matches_monolithic_and_jax(k):
    """partition 1 -> ship activation -> partition 2 == full model logits,
    and == JAX's executor on the same weights."""
    jcfg, tcfg, jp, tp = _pair("qwen1.5-0.5b")
    toks = _tokens(jcfg.vocab, 1, 32)
    p1, p2 = split_params(tcfg, tp, k)
    act = run_partition(tcfg, p1, {"tokens": torch.from_numpy(toks)}, part=1, device="cpu")
    assert act.shape == (1, 32, tcfg.d_model)
    logits = run_partition(tcfg, p2, act, part=2, device="cpu")
    mono = logits_fn(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(logits), _np(mono), rtol=2e-3, atol=2e-3)
    j1, j2 = j_split(jcfg, jp, k)
    j_act = j_run_partition(jcfg, j1, {"tokens": jnp.asarray(toks)}, part=1, k=k)
    np.testing.assert_allclose(_np(act), _np(j_act), **FP32_TOL)
    np.testing.assert_allclose(_np(logits), _np(j_run_partition(jcfg, j2, j_act, part=2, k=k)), **FP32_TOL)
    # The partitions share the model's parameters; nothing is copied.
    assert p2.embed.embed.data_ptr() == tp.embed.embed.data_ptr()
    with pytest.raises(ValueError, match="part must be 1 or 2"):
        run_partition(tcfg, p2, act, part=3, device="cpu")
