"""Port parity: the serve loop (repro_torch.launch.serve) against the JAX
package's serve CLI and a JAX greedy prefill/decode oracle, on the CPU.

Tokens are compared in fp32 compute, where both frameworks give the same
logits to ~1e-6; every compared token's top-2 logit margin in the oracle
is asserted above 1e-4, so equality is not luck of a near-tie.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro import models as jm
from repro.configs import reduced_config as j_reduced
from repro.launch import serve as j_serve
from repro.launch.steps import serve_config as j_serve_config
from repro_torch.configs import reduced_config
from repro_torch.launch import serve as t_serve
from repro_torch.launch.steps import serve_config
from repro_torch.models.convert import params_from_jax
from repro_torch.obs import MetricsRegistry

MARGIN = 1e-4


def _greedy_oracle(cfg, params, prompts, max_new, max_seq):
    """JAX: prefill every prompt, then decode greedily, recording what the
    serve loop records (the tokens after the prefill's own)."""
    prefill = jax.jit(jm.prefill, static_argnums=(0, 3))
    decode = jax.jit(jm.decode_step, static_argnums=0)
    caches, logits = prefill(cfg, params, {"tokens": jnp.asarray(prompts)}, max_seq)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out, margins = [], []
    pos = prompts.shape[1]
    for _ in range(max_new):
        logits, caches = decode(cfg, params, caches, tok, jnp.int32(pos))
        lg = np.asarray(logits[:, 0], np.float32)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.asarray(lg.argmax(-1)[:, None].astype(np.int32))
        out.append(lg.argmax(-1))
        pos += 1
    return np.stack(out, 1), np.stack(margins, 1)


@pytest.mark.parametrize("requests,slots", [(4, 4), (6, 4)])
def test_serve_tokens_match_jax_greedy_oracle(requests, slots):
    """One prefill wave, and two (the second admitted by a re-prefill with
    two idle slots running dummy prompts)."""
    jcfg = dataclasses.replace(j_serve_config(j_reduced("qwen1.5-0.5b")), compute_dtype="float32")
    tcfg = dataclasses.replace(serve_config(reduced_config("qwen1.5-0.5b")), compute_dtype="float32")
    jp = jm.init_params(jcfg, jax.random.PRNGKey(4))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    prompts = np.random.RandomState(2).randint(0, jcfg.vocab, (requests, 16)).astype(np.int32)
    max_new, max_seq = 6, 64
    want, margins = _greedy_oracle(jcfg, jp, prompts, max_new, max_seq)
    assert margins.min() > MARGIN, margins.min()
    tokens, summary = t_serve.serve(
        tcfg, tp, prompts, batch_slots=slots, max_new=max_new, max_seq=max_seq,
        device="cpu", registry=MetricsRegistry(),
    )
    assert np.array_equal(np.asarray(tokens), want)
    assert summary["requests"] == requests
    assert summary["generated_tokens"] == requests * max_new
    assert summary["decode_steps"] == max_new * -(-requests // slots)
    assert summary["metrics"]["serve.requests"] == requests


# (requests, slots, prompt_len, max_new, max_seq): one wave; two waves with
# idle slots; generation cut by max_seq before max_new.
CLI_CASES = [(4, 4, 16, 4, 64), (6, 4, 16, 5, 64), (5, 2, 16, 16, 24)]


@pytest.mark.parametrize("case", CLI_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cli_counts_match_jax(case, capsys):
    requests, slots, prompt_len, max_new, max_seq = case
    argv = [
        "--arch", "qwen1.5-0.5b", "--reduced", "--requests", str(requests),
        "--batch-slots", str(slots), "--prompt-len", str(prompt_len),
        "--max-new", str(max_new), "--max-seq", str(max_seq),
    ]
    assert j_serve.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert t_serve.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("requests", "decode_steps", "generated_tokens"):
        assert got[key] == want[key], key
    assert got.keys() == want.keys()
