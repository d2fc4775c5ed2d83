"""Port parity: the hybrid, encoder-decoder and modality-frontend families
(hymba-1.5b, seamless-m4t-medium, internvl2-76b, reduced) against the JAX
package on the CPU: logits, prefill and decode (seamless with 80-dim frame
features and decoder tokens, cross attention over 20 frames; internvl with
patch features), the executor's splits (encoder / decoder for seamless),
and what the port refuses as the reference does: interleaved hybrids in
`init_params`, encoder-decoder archs in `serve()`.

Inputs are numpy from a seed. Tolerances: fp32 rtol/atol 1e-4, bf16 JAX's
2e-3 / 1e-2 (harness doc in _torch_families.py).
"""
import jax
import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from _torch_families import BF16_TOL, FP32_TOL, check_executor, check_logits_prefill_decode
from repro.configs import reduced_config as j_reduced
from repro.models import init_params as j_init_params
from repro_torch.configs import ZOO, get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import encode, init_params


@pytest.mark.parametrize("arch,compute_dtype", [
    ("hymba-1.5b", "float32"), ("hymba-1.5b", "bfloat16"),
    ("seamless-m4t-medium", "float32"), ("internvl2-76b", "float32"),
])
def test_logits_prefill_decode_match_jax(arch, compute_dtype):
    """internvl's decode steps embed tokens where its forward projected
    patch features (as in JAX), so they are held to JAX's decode only."""
    check_logits_prefill_decode(arch, compute_dtype, FP32_TOL if compute_dtype == "float32" else BF16_TOL,
                                against_forward=arch != "internvl2-76b")


@pytest.mark.parametrize("arch,k", [("hymba-1.5b", 1), ("seamless-m4t-medium", 2), ("internvl2-76b", 1)])
def test_executor_matches_monolithic_and_jax(arch, k):
    check_executor(arch, k)


def test_encode_is_bidirectional():
    """The encoder's memory at a frame depends on later frames."""
    cfg = reduced_config("seamless-m4t-medium")
    params = init_params(cfg, 0, device="cpu")
    feats = torch.from_numpy(np.random.RandomState(0).randn(1, 12, cfg.frontend_dim).astype(np.float32))
    mem = encode(cfg, params, {"feats": feats})
    mem_cut = encode(cfg, params, {"feats": feats[:, :6]})
    assert mem.shape == (1, 12, cfg.d_model)
    assert not torch.allclose(mem[:, :6], mem_cut, atol=1e-3)


@pytest.mark.parametrize("arch", [a for a in ZOO if get_config(a).hybrid_attn_period >= 1])
def test_interleaved_hybrids_raise_like_jax(arch):
    with pytest.raises(ValueError) as want:
        j_init_params(j_reduced(arch), jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as got:
        init_params(reduced_config(arch), device="cpu")
    assert str(got.value) == str(want.value)


def test_serve_refuses_encoder_decoder():
    """The reference serve CLI fails at its first encdec prefill with
    KeyError: 'dec_tokens'; the port raises ValueError naming it, in
    `serve()` and in the CLI, before any prefill."""
    cfg = reduced_config("seamless-m4t-medium")
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="dec_tokens"):
        serve.serve(cfg, params, np.zeros((2, 4), np.int32), batch_slots=2, max_new=2, max_seq=16,
                    device="cpu")
    with pytest.raises(ValueError, match="ROADMAP"):
        serve.main(["--arch", "seamless-m4t-medium", "--reduced", "--requests", "1", "--device", "cpu"])
