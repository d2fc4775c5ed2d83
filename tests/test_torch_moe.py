"""Port parity: the mixture-of-experts layer (repro_torch.models.layers:
`moe_apply`, `_moe_dispatch_combine`, `moe_capacity`) and the moe family
(mixtral-8x22b and qwen2-moe-a2.7b, reduced) against the JAX package on
the CPU.

The layer is held with capacity drops (the default capacity factor 1.25),
with qwen2-moe's shared expert, with two dispatch groups, and on router
logits with exact ties, where the experts chosen must be
`jax.lax.top_k`'s (the lower index first). Inputs are numpy from a seed.
Tolerances: fp32 rtol/atol 1e-4, bf16 JAX's 2e-3 / 1e-2 (harness doc in
_torch_families.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from _torch_families import (
    BF16_TOL,
    FP32_TOL,
    check_executor,
    check_logits_prefill_decode,
    check_serve_tokens,
    no_drop,
    pair,
    to_np,
)
from repro.models import layers as j_layers
from repro_torch.configs import reduced_config
from repro_torch.models import decode_step, init_params, logits_fn, prefill
from repro_torch.models import layers as t_layers
from repro_torch.models.model import ParamTree
from repro_torch.models.routes import record_routes


def _layer0(jp, tp):
    return jax.tree.map(lambda a: a[0], jp["blocks"]["moe"]), tp.blocks[0].moe


def _drops(cfg, logits: np.ndarray, n_tokens: int) -> int:
    """Entries over capacity for these router logits (JAX's top_k order)."""
    cap = j_layers.moe_capacity(cfg, n_tokens)
    top = np.asarray(jax.lax.top_k(jnp.asarray(logits), cfg.top_k)[1]).ravel()
    return int(sum(max(0, c - cap) for c in np.bincount(top, minlength=cfg.n_experts)))


@pytest.mark.parametrize("arch,kw", [
    ("mixtral-8x22b", {}),  # capacity drops at the default factor
    ("qwen2-moe-a2.7b", {}),  # shared expert and its sigmoid gate
    ("mixtral-8x22b", {"moe_groups": 2}),  # two dispatch groups
], ids=["drops", "shared_expert", "groups_2"])
def test_moe_apply_matches_jax(arch, kw):
    jcfg, tcfg, jp, tp = pair(arch, **kw)
    jm_p, tm_p = _layer0(jp, tp)
    rng = np.random.RandomState(5)
    # A direction shared by every token skews the routing, so experts overflow.
    x = (rng.randn(2, 16, jcfg.d_model) + 2.0 * rng.randn(jcfg.d_model)).astype(np.float32)
    want = j_layers.moe_apply(jm_p, jnp.asarray(x), jcfg)
    got = t_layers.moe_apply(tm_p, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32_TOL)
    if arch == "qwen2-moe-a2.7b":
        assert hasattr(tm_p, "shared") and tm_p.shared_gate.shape == (jcfg.d_model, 1)
    logits = x.reshape(-1, jcfg.d_model) @ np.asarray(jm_p["router"])
    groups = max(1, jcfg.moe_groups)
    per_group = [_drops(jcfg, g, len(g)) for g in np.split(logits, groups)]
    if not kw:
        assert sum(per_group) > 0, "no token was dropped: the drop path went untested"
    # The same inputs twice: bitwise the same (no atomics in the combine).
    assert torch.equal(got, t_layers.moe_apply(tm_p, torch.from_numpy(x), tcfg))


def test_moe_dispatch_on_exact_router_ties_matches_jax():
    """Integer activations and router weights give integer logits, exact in
    any summation order, with many ties among the 8 experts: the experts
    chosen must be JAX's (the lower index first), or the outputs differ."""
    jcfg, tcfg, jp, tp = pair("mixtral-8x22b", capacity_factor=4.0)
    rng = np.random.RandomState(7)
    router = rng.randint(-1, 2, (jcfg.d_model, jcfg.n_experts)).astype(np.float32)
    jm_p = dict(jax.tree.map(lambda a: a[0], jp["blocks"]["moe"]), router=jnp.asarray(router))
    t_tree = {k: getattr(tp.blocks[0].moe, k) for k in ("wi_e", "wg_e", "wo_e")}
    tm_p = ParamTree({**t_tree, "router": torch.from_numpy(router)})
    # Sparse integer activations: small integer logits, many exact ties.
    x = (rng.randint(-1, 2, (32, jcfg.d_model)) * (rng.rand(32, jcfg.d_model) < 0.1)).astype(np.float32)
    logits = x @ router
    top2 = -np.sort(-logits, axis=-1)[:, :3]
    assert (top2[:, 1] == top2[:, 2]).sum() >= 4, "too few ties at the top-k boundary"
    cap = j_layers.moe_capacity(jcfg, 32)
    want = j_layers._moe_dispatch_combine(jm_p, jnp.asarray(x), jcfg, cap)
    got = t_layers._moe_dispatch_combine(tm_p, torch.from_numpy(x), tcfg, cap)
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32_TOL)


def test_recorded_routes_match_jax_top_k():
    """`record_routes` (the near-tie rule the parity checks share) on
    integer router logits: each token's experts are `jax.lax.top_k`'s set,
    and its gap is the k-th minus the (k+1)-th logit in bf16 ulps of the
    k-th, 0 (a near-tie) exactly where those two tie."""
    jcfg, tcfg, jp, tp = pair("mixtral-8x22b", capacity_factor=4.0)
    rng = np.random.RandomState(7)
    router = rng.randint(-1, 2, (jcfg.d_model, jcfg.n_experts)).astype(np.float32)
    x = (rng.randint(-1, 2, (32, jcfg.d_model)) * (rng.rand(32, jcfg.d_model) < 0.1)).astype(np.float32)
    moe = {k: getattr(tp.blocks[0].moe, k) for k in ("wi_e", "wg_e", "wo_e")}
    with record_routes() as routes:
        t_layers._moe_dispatch_combine(ParamTree({**moe, "router": torch.from_numpy(router)}),
                                       torch.from_numpy(x), tcfg, 64)
    (route,) = routes
    logits = x @ router
    _, want = jax.lax.top_k(jnp.asarray(logits), jcfg.top_k)
    np.testing.assert_array_equal(route.experts.numpy(), np.sort(np.asarray(want), axis=-1))
    desc = -np.sort(-logits, axis=-1)
    kth, nxt = desc[:, jcfg.top_k - 1], desc[:, jcfg.top_k]
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(kth), 2.0 ** -126))) - 7)
    np.testing.assert_allclose(route.gap.numpy(), (kth - nxt) / ulp, rtol=0, atol=0)
    assert 4 <= int(route.near_tie().sum()) < 32 and bool((route.near_tie().numpy() == (kth - nxt <= 4 * ulp)).all())


@pytest.mark.parametrize("arch,compute_dtype", [
    ("mixtral-8x22b", "float32"), ("qwen2-moe-a2.7b", "float32"), ("qwen2-moe-a2.7b", "bfloat16"),
])
def test_moe_logits_prefill_decode_match_jax(arch, compute_dtype):
    """fp32 at the default capacity (prefill and the full forward drop
    different tokens, so decode is held to JAX's decode only). bf16 at the
    no-drop capacity: bf16 router logits tie or nearly tie, and the two
    frameworks' roundings can send a token to another expert, which with
    drops could change which other tokens overflow; positions a near-tie
    reaches are left out (`near_ties`)."""
    if compute_dtype == "float32":
        check_logits_prefill_decode(arch, compute_dtype, FP32_TOL, against_forward=False)
    else:
        check_logits_prefill_decode(arch, compute_dtype, BF16_TOL, against_forward=False, moe_near_ties=True)


def test_moe_decode_matches_forward_without_drops():
    """JAX's no-drop capacity (test_models.py `_no_drop`): prefill and then
    decode steps equal the port's own full forward."""
    cfg = no_drop(dataclasses.replace(reduced_config("mixtral-8x22b"), compute_dtype="float32"))
    params = init_params(cfg, 3, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(3).randint(0, cfg.vocab, (1, 23)).astype(np.int32))
    full = logits_fn(cfg, params, {"tokens": toks})
    caches, last = prefill(cfg, params, {"tokens": toks[:, :17]}, 64)
    np.testing.assert_allclose(to_np(last[:, 0]), to_np(full[:, 16]), **FP32_TOL)
    for pos in range(17, 22):
        lg, caches = decode_step(cfg, params, caches, toks[:, pos:pos + 1], pos)
        np.testing.assert_allclose(to_np(lg[:, 0]), to_np(full[:, pos]), **FP32_TOL)


def test_mixtral_executor_matches_monolithic_and_jax():
    check_executor("mixtral-8x22b", 1)


def test_qwen2_moe_serve_tokens_match_jax_greedy_oracle():
    """One wave of four requests on four slots: capacity drops depend on
    the batch a token is routed with, so the oracle's batch must be the
    serve loop's."""
    check_serve_tokens("qwen2-moe-a2.7b", requests=4, slots=4)
