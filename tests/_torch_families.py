"""Parity harness for the port's model-family tests (`test_torch_ssm.py`,
`test_torch_moe.py`, `test_torch_families.py`, `test_torch_quant.py`).

The same numpy inputs (made from a seed) go through a JAX function and its
port; JAX weights enter the port through `params_from_jax`. The JAX entry
points are jitted once here, at import, and compile once per config in
each test process (eager calls would recompile their layer scans on every
call).

Tolerances: fp32 compute rtol/atol 1e-4 (the same arithmetic summed in
another order; measured <= 3e-6 on the reduced configs). bf16 compute:
JAX's own prefill-vs-forward tolerance, rtol 2e-3 and atol 1e-2
(test_models.py): XLA fuses elementwise chains in fp32 where PyTorch
rounds each op to bf16 (measured <= 8.8e-3 for hymba and qwen2-moe).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import models as jm
from repro.configs import reduced_config as j_reduced
from repro.launch.steps import serve_config as j_serve_config
from repro.partition import run_partition as j_run_partition
from repro.partition import split_params as j_split
from repro_torch.configs import reduced_config
from repro_torch.launch import serve as t_serve
from repro_torch.launch.steps import serve_config
from repro_torch.models import decode_step, logits_fn, prefill
from repro_torch.models.convert import params_from_jax
from repro_torch.models.routes import record_routes
from repro_torch.obs import MetricsRegistry
from repro_torch.partition import run_partition, split_params

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-4  # serve tokens: every compared step's top-2 margin in the oracle
BF16_TOL = dict(rtol=2e-3, atol=1e-2)

j_logits = jax.jit(jm.logits_fn, static_argnums=0)
j_prefill = jax.jit(jm.prefill, static_argnums=(0, 3))
j_decode = jax.jit(jm.decode_step, static_argnums=0)


def no_drop(cfg):
    """JAX's `_no_drop` (test_models.py): a capacity no expert overflows."""
    if cfg.family == "moe":
        return dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k + 1.0)
    return cfg


def configs(arch, compute_dtype="float32", **kw):
    jcfg = dataclasses.replace(j_reduced(arch), compute_dtype=compute_dtype, **kw)
    tcfg = dataclasses.replace(reduced_config(arch), compute_dtype=compute_dtype, **kw)
    return jcfg, tcfg


def pair(arch, compute_dtype="float32", seed=0, **kw):
    """(JAX config, port config, JAX params, the same params in the port)."""
    jcfg, tcfg = configs(arch, compute_dtype, **kw)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def to_np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def tokens(vocab, b, s, seed=1) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


def batch(cfg, toks: np.ndarray, seed=2, enc_len=20) -> dict:
    """The model's batch format (model.py's doc) around `toks`: an encdec
    arch gets `enc_len` random frames and `toks` as its decoder tokens, a
    frontend arch one random feature vector a token position."""
    rng = np.random.RandomState(seed)
    if cfg.family == "encdec":
        feats = rng.randn(toks.shape[0], enc_len, cfg.frontend_dim).astype(np.float32)
        return {"feats": feats, "dec_tokens": toks}
    if cfg.frontend != "none":
        return {"feats": rng.randn(*toks.shape, cfg.frontend_dim).astype(np.float32)}
    return {"tokens": toks}


def prefix(b: dict, n: int) -> dict:
    """The first n positions of a batch (of the decoder, for encdec)."""
    if "dec_tokens" in b:
        return {**b, "dec_tokens": b["dec_tokens"][:, :n]}
    return {k: v[:, :n] for k, v in b.items()}


def jb(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def tb(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def near_ties(routes: list, batch_size: int, n_layers: int, seen=None):
    """Positions ([B, S] bool) a router near-tie (`Route.near_tie`) may
    have sent to other experts than JAX's: the token itself at the last
    layer, and it and every later position of its sequence at an earlier
    layer (attention carries it on); and [B] whether such an earlier-layer
    near-tie reaches past the last position. `routes`: one run's
    `record_routes()`; `seen` ([B] bool): a near-tie that reached these
    positions from before them."""
    ties = [r.near_tie().reshape(batch_size, -1).numpy() for r in routes]
    near = np.zeros(ties[0].shape, bool) if seen is None else np.repeat(seen[:, None], ties[0].shape[1], 1)
    carried = near.copy()
    for layer, tie in enumerate(ties):
        if layer == n_layers - 1:
            near |= tie
        else:
            carried |= np.maximum.accumulate(tie, axis=1)
    return near | carried, carried[:, -1]


def _assert_close_where(got, want, keep: np.ndarray, tol: dict):
    """assert_allclose on the positions `keep` ([B, S] bool) of [B, S, V];
    returns how many were compared."""
    np.testing.assert_allclose(to_np(got)[keep], to_np(want)[keep], **tol)
    return int(keep.sum())


def check_logits_prefill_decode(arch, compute_dtype, tol, *, against_forward=True, moe_near_ties=False):
    """logits_fn, prefill (logits and caches) and five decode steps of the
    reduced `arch` against JAX on the same weights; with `against_forward`
    every decode step also against the port's own full forward.

    `moe_near_ties` (bf16 MoE, at the no-drop capacity so that routing
    stays per token): positions a router near-tie may have routed to other
    experts than JAX's (`near_ties`) are left out and the rest compared at
    `tol`; at most half the forward's positions may be left out, and some
    decode step must be compared."""
    jcfg, tcfg, jp, tp = pair(arch, compute_dtype)
    if moe_near_ties:
        jcfg, tcfg = no_drop(jcfg), no_drop(tcfg)
    cache_tol = FP32_TOL if compute_dtype == "float32" else dict(rtol=2e-2, atol=3e-2)
    toks = tokens(jcfg.vocab, 2, 24)
    full = batch(jcfg, toks)
    t_pre, total = 17, 64
    n_layers = tcfg.n_layers
    want = j_logits(jcfg, jp, jb(full))
    with record_routes() as routes:
        got = logits_fn(tcfg, tp, tb(full))
    assert got.shape == (2, 24, tcfg.vocab)
    keep = ~near_ties(routes, 2, n_layers)[0] if moe_near_ties else np.ones((2, 24), bool)
    assert keep.mean() >= 0.5, f"router near-ties reach {(~keep).sum()} of {keep.size} positions"
    print("positions a router near-tie reaches, left out:", np.argwhere(~keep).tolist())
    _assert_close_where(got, want, keep, tol)

    jc, jl = j_prefill(jcfg, jp, jb(prefix(full, t_pre)), total)
    with record_routes() as routes:
        tc, tl = prefill(tcfg, tp, tb(prefix(full, t_pre)), total)
    seen = np.zeros(2, bool)
    if moe_near_ties:
        near, seen = near_ties(routes, 2, n_layers)
        _assert_close_where(tl, jl, ~near[:, -1:], tol)
    else:
        np.testing.assert_allclose(to_np(tl), to_np(jl), **tol)
    assert len(tc) == len(jax.tree.leaves(jc)[0])
    for layer, cache in enumerate(tc):
        for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
            ref = jc
            for k in path:
                ref = ref[k.key]
            np.testing.assert_allclose(to_np(leaf)[~seen], to_np(ref[layer])[~seen], **cache_tol)
    compared = 0
    for pos in range(t_pre, t_pre + 5):
        tok = toks[:, pos:pos + 1]
        jl, jc = j_decode(jcfg, jp, jc, jnp.asarray(tok), jnp.int32(pos))
        with record_routes() as routes:
            tl, tc = decode_step(tcfg, tp, tc, torch.from_numpy(tok), pos)
        near = np.zeros((2, 1), bool)
        if moe_near_ties:
            near, seen = near_ties(routes, 2, n_layers, seen)
        compared += _assert_close_where(tl, jl, ~near, tol)
        if against_forward:
            np.testing.assert_allclose(to_np(tl[:, 0]), to_np(got[:, pos]), **tol)
    assert compared > 0, "router near-ties left no decode step to compare"


def check_executor(arch, k):
    """Partition 1 -> activation -> partition 2 against the port's
    monolithic logits (test_partition.py's rtol/atol 2e-3) and against JAX's
    executor on the same weights (fp32 tolerance), as test_partition.py
    splits: encdec encoder / decoder, the others at layer k."""
    jcfg, tcfg, jp, tp = pair(arch)
    b = batch(jcfg, tokens(jcfg.vocab, 1, 32), enc_len=32)
    p1, p2 = split_params(tcfg, tp, k)
    j1, j2 = j_split(jcfg, jp, k)
    enc_in = {k_: v for k_, v in b.items() if k_ != "dec_tokens"}
    act = run_partition(tcfg, p1, tb(enc_in), part=1, device="cpu")
    j_act = j_run_partition(jcfg, j1, jb(enc_in), part=1, k=k)
    assert act.shape == (1, 32, tcfg.d_model)
    np.testing.assert_allclose(to_np(act), to_np(j_act), **FP32_TOL)
    if jcfg.family == "encdec":
        t_in = {"memory": act, "dec_tokens": torch.from_numpy(b["dec_tokens"])}
        j_in = {"memory": j_act, "dec_tokens": jnp.asarray(b["dec_tokens"])}
    else:
        t_in, j_in = act, j_act
    logits = run_partition(tcfg, p2, t_in, part=2, device="cpu")
    mono = logits_fn(tcfg, tp, tb(b))
    np.testing.assert_allclose(to_np(logits), to_np(mono), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(to_np(logits), to_np(j_run_partition(jcfg, j2, j_in, part=2, k=k)), **FP32_TOL)
    assert p2.embed.embed.data_ptr() == tp.embed.embed.data_ptr()  # shared, not copied


def greedy_oracle(cfg, params, prompts, max_new, max_seq):
    """JAX: prefill every prompt, then decode greedily, recording what the
    serve loop records (the tokens after the prefill's own), and each
    step's top-2 logit margin."""
    caches, logits = j_prefill(cfg, params, {"tokens": jnp.asarray(prompts)}, max_seq)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out, margins = [], []
    pos = prompts.shape[1]
    for _ in range(max_new):
        logits, caches = j_decode(cfg, params, caches, tok, jnp.int32(pos))
        lg = np.asarray(logits[:, 0], np.float32)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.asarray(lg.argmax(-1)[:, None].astype(np.int32))
        out.append(lg.argmax(-1))
        pos += 1
    return np.stack(out, 1), np.stack(margins, 1)


def check_serve_tokens(arch, requests=6, slots=4, max_new=5, max_seq=64, seed=4):
    """`serve()` on the reduced arch's serve config in fp32 compute against
    JAX's prefill + greedy decode: six requests on four slots take a
    re-prefill with two idle slots. Every compared token's top-2 margin in
    the oracle is asserted above MARGIN, so equality is not the luck of a
    near-tie."""
    jcfg = dataclasses.replace(j_serve_config(j_reduced(arch)), compute_dtype="float32")
    tcfg = dataclasses.replace(serve_config(reduced_config(arch)), compute_dtype="float32")
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    prompts = tokens(jcfg.vocab, requests, 16, seed=2)
    want, margins = greedy_oracle(jcfg, jp, prompts, max_new, max_seq)
    assert margins.min() > MARGIN, margins.min()
    got, summary = t_serve.serve(tcfg, tp, prompts, batch_slots=slots, max_new=max_new,
                                 max_seq=max_seq, device="cpu", registry=MetricsRegistry())
    assert np.array_equal(np.asarray(got), want)
    waves = -(-requests // slots)
    assert (summary["requests"], summary["generated_tokens"], summary["decode_steps"]) == (
        requests, requests * max_new, waves * max_new)
