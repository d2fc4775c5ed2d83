"""Port parity: the training path (repro_torch.data, .optim, .checkpoint,
models.loss_fn, the flash attention's plain backward, launch.steps)
against the JAX package on the CPU, on the same numpy inputs.

Tolerances, each with its reason:
- data stream, int8 compression: bitwise (the same numpy draws; torch.round
  and jnp.round both round half to even);
- AdamW, clipping, the cosine schedule: rtol 1e-6 (the same fp32
  arithmetic; the global norm sums its leaves in another order);
- the flash backward: fp32 rtol/atol 1e-5 (the same softmax gradient,
  summed in another order); a row that sees no key exactly 0;
- loss_fn and its gradients, fp32 compute: loss rtol 1e-5, every leaf's
  relative L2 error <= 1e-4 (measured <= 1.7e-6 on every family);
- the train step over 3 steps: loss and grad norm rtol 1e-4; mu and nu
  rtol 1e-4 with atol 1e-4 x the leaf's largest magnitude (a gradient
  element near 0 has no relative precision); params rtol 1e-4 with atol
  1e-2 x lr: AdamW divides by sqrt(vhat) + eps, so an element whose
  gradient sits near eps (the key bias, whose gradient RoPE alone keeps
  from vanishing) moves by up to lr on gradient differences of summation
  order (measured 7.8e-3 x lr);
- remat on and off: bitwise (the same ops recomputed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from _torch_families import batch, configs, jb, tb, tokens
from repro import models as jm
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import DataConfig as JDataConfig
from repro.data import make_pipeline as j_make_pipeline
from repro.kernels.flash_attention.ref import attention_chunked as j_chunked
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro.launch.steps import make_train_step as j_make_train_step
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import compress_int8 as j_compress
from repro.optim import cosine_schedule as j_cosine
from repro.optim import decompress_int8 as j_decompress
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.kernels.flash_attention import attention_chunked, ops as fa_ops
from repro_torch.launch import steps
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models import decode_step, init_params, loss_fn, prefill, quantize_params, trainable
from repro_torch.models.convert import named_to_numpy, opt_state_from_jax, opt_state_to_numpy, params_to_numpy
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, compress_int8, cosine_schedule
from repro_torch.optim import decompress_int8


def pair(arch, **overrides):
    """(JAX config, port config, JAX params, port params) in fp32 compute:
    the port draws the weights, which cross into JAX through
    `params_to_numpy` (JAX's eager `init_params` costs seconds a config)."""
    jcfg, tcfg = configs(arch, **overrides)
    tp = init_params(tcfg, 0, device="cpu")
    return jcfg, tcfg, jax.tree.map(jnp.asarray, params_to_numpy(tp)), tp


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm((got - want).ravel()) / max(np.linalg.norm(want.ravel()), 1e-30))


def _leaves_with_paths(tree):
    return [(jax.tree_util.keystr(p), np.asarray(a)) for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _pick(tree, keystr_path: str):
    for key in keystr_path.strip("[]'").split("']['"):
        tree = tree[key]
    return tree


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq_len,batch_size", [(512, 64, 4), (1000, 128, 8), (97, 48, 3)])
def test_data_pipeline_bitwise_jax(vocab, seq_len, batch_size):
    """Batches at steps 0-5 and `state()`; then a restore from step 3's
    state continues the stream bitwise, as JAX's restore does."""
    jcfg = JDataConfig(vocab=vocab, seq_len=seq_len, global_batch=batch_size, seed=77)
    tcfg = DataConfig(vocab=vocab, seq_len=seq_len, global_batch=batch_size, seed=77)
    jp, tp = j_make_pipeline(jcfg), make_pipeline(tcfg)
    for _ in range(6):
        got, want = tp.next_batch(), jp.next_batch()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert tp.state() == jp.state()
    jr = j_make_pipeline(jcfg, {"seed": 77, "step": 3})
    tr = make_pipeline(tcfg, {"seed": 77, "step": 3})
    for _ in range(3):
        np.testing.assert_array_equal(tr.next_batch(), jr.next_batch())
    assert tr.state() == jr.state() == {"seed": 77, "step": 6}
    with pytest.raises(ValueError, match="seed"):
        make_pipeline(tcfg, {"seed": 78, "step": 0})


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _opt_tree(seed):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(16, 8).astype(np.float32), "b": {"c": rng.randn(5).astype(np.float32),
                                                           "d": rng.randn(3, 4, 2).astype(np.float32)}}


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_named(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: torch.from_numpy(v)})
    return out


def _nested(named):
    out = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = np.asarray(t)
    return out


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_five_steps_match_jax(weight_decay):
    jp = jax.tree.map(jnp.asarray, _opt_tree(0))
    tp = _named(_opt_tree(0))
    jo, to = j_adamw_init(jp), adamw_init(tp)
    assert to["step"].dtype == torch.int32 and all(m.dtype == torch.float32 for m in to["mu"].values())
    for s in range(5):
        g = _opt_tree(10 + s)
        jp, jo = j_adamw_update(jax.tree.map(jnp.asarray, g), jo, jp, 1e-2, weight_decay=weight_decay)
        tp, to = adamw_update(_named(g), to, tp, 1e-2, weight_decay=weight_decay)
    for tree_t, tree_j in ((tp, jp), (to["mu"], jo["mu"]), (to["nu"], jo["nu"])):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7),
                     _nested(tree_t), tree_j)
    assert int(to["step"]) == int(jo["step"]) == 5


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _opt_tree(3)
    jg, jn = j_clip(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = clip_by_global_norm(_named(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7), _nested(tg), jg)


def test_cosine_schedule_matches_jax():
    kw = dict(peak_lr=3e-4, warmup=10, total=100, min_frac=0.1)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(j_cosine(jnp.int32(s), **kw))
        got = float(cosine_schedule(torch.tensor(s, dtype=torch.int32), **kw))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("with_error", [False, True])
def test_compress_int8_bitwise_jax(with_error):
    rng = np.random.RandomState(5)
    x = (rng.randn(64, 33) * 3).astype(np.float32)
    x[0, :4] = [0.5, 1.5, -2.5, 127.0]  # halves on the grid after scaling
    err = rng.randn(64, 33).astype(np.float32) * 1e-2 if with_error else None
    jq, js, je = j_compress(jnp.asarray(x), None if err is None else jnp.asarray(err))
    tq, ts, te = compress_int8(torch.from_numpy(x), None if err is None else torch.from_numpy(err))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(decompress_int8(tq, ts).numpy(), np.asarray(j_decompress(jq, js)))


# ---------------------------------------------------------------------------
# checkpoint manager (tests/test_substrate.py's cases, on the port's trees)
# ---------------------------------------------------------------------------
def _ck_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 16, generator=g),
            "nested": {"b": torch.arange(5.0) + seed, "step": torch.tensor(3, dtype=torch.int32),
                       "h": torch.randn(4, generator=g).to(torch.bfloat16)}}


def _assert_tree_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        cm = CheckpointManager(tmp_path)
        tree = _ck_tree()
        cm.save(10, tree, extra={"data": {"seed": 1, "step": 10}})
        got, extra, step = cm.restore(None, tree, device="cpu")
        assert step == 10 and extra["data"]["step"] == 10
        _assert_tree_equal(got, tree)

    def test_keep_k_prunes(self, tmp_path):
        cm = CheckpointManager(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            cm.save(s, _ck_tree())
        assert cm.steps() == [3, 4]

    def test_latest_and_explicit_step(self, tmp_path):
        cm = CheckpointManager(tmp_path, keep=5)
        cm.save(1, _ck_tree(1))
        cm.save(2, _ck_tree(2))
        got, _, step = cm.restore(1, _ck_tree(), device="cpu")
        assert step == 1
        _assert_tree_equal(got, _ck_tree(1))
        assert cm.restore(None, _ck_tree(), device="cpu")[2] == 2

    def test_interrupted_save_keeps_previous(self, tmp_path):
        """A .tmp dir left behind by a crash must not shadow the good ckpt."""
        cm = CheckpointManager(tmp_path)
        cm.save(5, _ck_tree())
        (tmp_path / "step_00000009.tmp").mkdir()
        assert cm.latest_step() == 5
        _, _, step = cm.restore(None, _ck_tree(), device="cpu")
        assert step == 5

    def test_structure_mismatch_rejected(self, tmp_path):
        cm = CheckpointManager(tmp_path)
        cm.save(1, _ck_tree())
        with pytest.raises(ValueError, match="missing"):
            cm.restore(None, {"only_one": torch.zeros(3)}, device="cpu")
        bad_shape = _ck_tree()
        bad_shape["w"] = torch.zeros(8, 15)
        with pytest.raises(ValueError, match="differs"):
            cm.restore(None, bad_shape, device="cpu")

    def test_restore_into_another_model_and_device(self, tmp_path, monkeypatch):
        """A model and its AdamW state saved, then restored into a fresh
        model from another seed: every leaf bitwise, bf16 leaves included.
        Restoring onto the GPU without one raises (no CPU fallback); the
        card-to-CPU-and-back restore runs in chip_smoke.py phase 11."""
        cfg = dataclasses.replace(reduced_config("qwen1.5-0.5b"), param_dtype="bfloat16")
        model = init_params(cfg, 0, device="cpu")
        opt = adamw_init(model)
        cm = CheckpointManager(tmp_path)
        cm.save(7, {"params": model, "opt": opt}, extra={"data": {"seed": 1, "step": 7}})
        fresh = init_params(cfg, 1, device="cpu")
        tree, _, _ = cm.restore(None, {"params": fresh, "opt": adamw_init(fresh)}, device="cpu")
        fresh.load_state_dict(tree["params"])
        assert fresh.embed.embed.dtype == torch.bfloat16
        for (n, a), (_, b) in zip(model.named_parameters(), fresh.named_parameters(), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b), n
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            cm.restore(None, {"params": fresh, "opt": opt})

    def test_manifest_names_leaves(self, tmp_path):
        """The manifest keys leaves by name, as the port's trees name them,
        and a checkpoint written by the JAX manager is not mistaken for one."""
        cm = CheckpointManager(tmp_path)
        cm.save(1, _ck_tree())
        import json

        man = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
        assert [e["name"] for e in man["leaves"]] == ["w", "nested.b", "nested.step", "nested.h"]
        assert [e["dtype"] for e in man["leaves"]] == ["float32", "float32", "int32", "bfloat16"]
        JCheckpointManager(tmp_path / "jax").save(1, {"w": jnp.zeros(3)})
        with pytest.raises(KeyError):
            CheckpointManager(tmp_path / "jax").restore(None, {"w": torch.zeros(3)}, device="cpu")


# ---------------------------------------------------------------------------
# the flash attention's plain backward
# ---------------------------------------------------------------------------
# (B, H, Kv, Sq, Sk, D, causal, window, q_offset)
BWD_CASES = [
    (2, 4, 4, 32, 32, 16, True, None, 0),     # causal
    (1, 4, 2, 24, 40, 16, True, 8, 16),       # GQA 2:1, window, q_offset
    (2, 6, 2, 33, 33, 8, False, None, 0),     # bidirectional GQA 3:1
    (1, 2, 1, 16, 16, 8, True, None, -4),     # rows 0-3 see no key
]


def _bwd_inputs(case, seed=0):
    b, h, kv, sq, sk, d = case[:6]
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d), (b, h, sq, d))]


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_backward_matches_jax_vjp(case, monkeypatch):
    """dq, dk, dv, in one chunk and (a threshold of 5 query rows' scores)
    in chunks of 5 rows, against
    jax.vjp of JAX's `attention_chunked` (its no-key rows are 0, as the
    kernel's) and, where every row sees a key, of `attention_ref`."""
    causal, window, q_offset = case[6:]
    q, k, v, do = _bwd_inputs(case)
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def refs(q_, k_, v_, do_):  # jitted: an eager vjp through the chunked scans traces for seconds
        fns = [lambda *a: j_chunked(*a, q_chunk=8, kv_chunk=16, **kw)]
        if q_offset >= 0:
            fns.append(lambda *a: j_ref(*a, **kw))
        return [jax.vjp(f, q_, k_, v_)[1](do_) for f in fns]

    wants = jax.jit(refs)(q, k, v, do)
    for threshold in (fa_ops._CHUNKED_THRESHOLD, 5 * k.shape[2]):
        monkeypatch.setattr(fa_ops, "_CHUNKED_THRESHOLD", threshold)
        got = fa_ops.flash_attention_backward(*map(torch.from_numpy, (q, k, v, do)), **kw)
        for want in wants:
            for g, w in zip(got, want, strict=True):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
        if q_offset < 0:
            assert bool((got[0][:, :, :-q_offset] == 0).all())


def test_flash_autograd_function_is_kernel_forward_plain_backward(monkeypatch):
    """The dispatcher op (`torch.ops.repro_torch.flash_attention`) on CPU
    tensors, with its implementation there (the plain route, `_plain`)
    stood in by the streaming recurrence (the kernel's plain version): its
    forward is the implementation, unchanged, and the gradients of its
    registered autograd are `flash_attention_backward`'s, which equal
    autograd through the recurrence."""
    case = BWD_CASES[1]
    causal, window, q_offset = case[6:]
    calls = []

    def fake_launch(q, k, v, c, w, off):
        calls.append((c, w, off))
        return attention_chunked(q, k, v, causal=c, window=w, q_offset=off, q_chunk=8, kv_chunk=16)

    monkeypatch.setattr(fa_ops, "_plain", fake_launch)
    arrs = [torch.from_numpy(a) for a in _bwd_inputs(case, seed=3)]
    q, k, v = (t.clone().requires_grad_() for t in arrs[:3])
    out = torch.ops.repro_torch.flash_attention(q, k, v, causal, window, q_offset)
    assert calls == [(causal, window, q_offset)]
    assert torch.equal(out, fake_launch(*arrs[:3], causal, window, q_offset))
    out.backward(arrs[3])
    q2, k2, v2 = (t.clone().requires_grad_() for t in arrs[:3])
    attention_chunked(q2, k2, v2, causal=causal, window=window, q_offset=q_offset).backward(arrs[3])
    for got, want in ((q.grad, q2.grad), (k.grad, k2.grad), (v.grad, v2.grad)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# loss_fn and its gradients, every family
# ---------------------------------------------------------------------------
# XLA's CPU backend at optimization level 0 compiles in about two thirds of
# the time; the arithmetic is the same fp32 graph.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def j_value_and_grad(cfg, params, data):
    fn = jax.jit(jax.value_and_grad(jm.loss_fn, argnums=1), static_argnums=0)
    return fn.lower(cfg, params, data).compile(FAST_COMPILE)(params, data)

# (arch, config overrides, batch size, sequence length)
LOSS_CASES = [
    ("qwen1.5-0.5b", {}, 2, 24),                       # dense
    ("qwen1.5-0.5b", {"vocab_chunking": 3}, 2, 24),    # dense, streamed cross entropy
    ("qwen2-moe-a2.7b", {}, 2, 24),                    # moe, capacity drops
    ("mamba2-370m", {}, 2, 24),                        # ssm, a padded SSD chunk
    ("hymba-1.5b", {}, 1, 40),                         # hybrid, past its 32 window
    ("internvl2-76b", {}, 2, 24),                      # frontend: feats + labels
    ("seamless-m4t-medium", {}, 2, 24),                # encdec: feats + dec_tokens
]


@pytest.mark.parametrize("arch,overrides,b,s", LOSS_CASES,
                         ids=[f"{a}{'-chunked' if o else ''}" for a, o, _, _ in LOSS_CASES])
def test_loss_and_grads_match_jax(arch, overrides, b, s):
    jcfg, tcfg, jp, tp = pair(arch, **overrides)
    data = batch(jcfg, tokens(jcfg.vocab, b, s))
    if jcfg.frontend != "none" and jcfg.family != "encdec":
        data["labels"] = tokens(jcfg.vocab, b, s, seed=5)
    want_loss, want_grads = j_value_and_grad(jcfg, jp, jb(data))
    got_loss, got_grads = value_and_grad(tcfg, tp, tb(data))
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(float(loss_fn(tcfg, tp, tb(data))), float(want_loss), rtol=1e-5)
    got = named_to_numpy(got_grads)
    want = _leaves_with_paths(want_grads)
    assert len(want) == len(jax.tree.leaves(got))
    for path, w in want:
        g = _pick(got, path)
        assert g.shape == w.shape and np.isfinite(g).all(), path
        assert _rel_l2(g, w) <= 1e-4, (path, _rel_l2(g, w))


def test_remat_is_bitwise_no_remat():
    """cfg.remat checkpoints each layer; the recomputed forward gives the
    same loss and gradients bit for bit."""
    cfg = dataclasses.replace(reduced_config("hymba-1.5b"), compute_dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    data = {"tokens": torch.from_numpy(tokens(cfg.vocab, 1, 20))}
    loss_a, grads_a = value_and_grad(dataclasses.replace(cfg, remat=False), params, data)
    loss_b, grads_b = value_and_grad(dataclasses.replace(cfg, remat=True), params, data)
    assert torch.equal(loss_a, loss_b)
    for n in grads_a:
        assert torch.equal(grads_a[n], grads_b[n]), n


def test_trainable_refuses_int8_and_serving_stays_frozen():
    cfg = reduced_config("qwen1.5-0.5b")
    params = init_params(cfg, 0, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    with pytest.raises(ValueError, match="int8"):
        trainable(quantize_params(params))
    leaves = trainable(params)
    assert leaves.keys() == dict(params.named_parameters()).keys()
    assert all(p.requires_grad for p in leaves.values())


def test_prefill_and_serve_steps_are_the_model_calls():
    cfg = dataclasses.replace(reduced_config("qwen1.5-0.5b"), compute_dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(tokens(cfg.vocab, 2, 12))
    with torch.inference_mode():
        caches, last = steps.make_prefill_step(cfg, 16)(params, {"tokens": toks[:, :8]})
        ref_caches, ref_last = prefill(cfg, params, {"tokens": toks[:, :8]}, 16)
        assert torch.equal(last, ref_last)
        logits, _ = steps.make_serve_step(cfg)(params, caches, toks[:, 8:9], 8)
        ref_logits, _ = decode_step(cfg, params, ref_caches, toks[:, 8:9], 8)
        assert torch.equal(logits, ref_logits)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_three_steps_match_jax(microbatches):
    """make_train_step against JAX's, jitted without a mesh, from the same
    params and AdamW state (`opt_state_from_jax`), on the data stream's
    batches."""
    lr = 1e-3
    jcfg, tcfg, jp, tp = pair("qwen1.5-0.5b")
    jo = j_adamw_init(jp)
    to = opt_state_from_jax(tcfg, jax.tree.map(np.asarray, jo), device="cpu")
    j_step = jax.jit(j_make_train_step(jcfg, lr=lr, microbatches=microbatches))
    j_step = j_step.lower(jp, jo, {"tokens": jnp.zeros((4, 32), jnp.int32)}).compile(FAST_COMPILE)
    t_step = make_train_step(tcfg, lr=lr, microbatches=microbatches)
    stream = make_pipeline(DataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=4, seed=7))
    for _ in range(3):
        toks = stream.next_batch()
        jp, jo, jmet = j_step(jp, jo, {"tokens": jnp.asarray(toks)})
        tp, to, tmet = t_step(tp, to, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
    got_p, got_o = params_to_numpy(tp), opt_state_to_numpy(to)
    assert int(got_o["step"]) == int(jo["step"]) == 3
    for path, w in _leaves_with_paths(jp):
        np.testing.assert_allclose(_pick(got_p, path), w, rtol=1e-4, atol=1e-2 * lr, err_msg=path)
    for key in ("mu", "nu"):
        for path, w in _leaves_with_paths(jo[key]):
            np.testing.assert_allclose(_pick(got_o[key], path), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(), err_msg=f"{key}{path}")
