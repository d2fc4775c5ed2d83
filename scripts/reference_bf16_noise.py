#!/usr/bin/env python3
"""The JAX reference's own bf16 noise on chip_smoke.py's prefill-then-decode
check: prefill of 64 tokens then 7 decode steps against the full forward of
72 (B=2, random tokens from seed 1), at full width and depth in the serve
config (bf16 parameters and compute, random weights from PRNGKey(0)), on
the CPU. Prints one JSON line an arch: the largest logit, the largest
difference, and that difference in bf16 ulps of the largest logit.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_bf16_noise.py \\
        qwen1.5-0.5b mamba2-370m hymba-1.5b

This runs the JAX package alone (the reference, not the port); a few
minutes and about 10 GB of host memory for hymba-1.5b.
"""
from __future__ import annotations

import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro import models as jm
from repro.configs import get_config
from repro.launch.steps import serve_config


def noise(arch: str) -> dict:
    cfg = serve_config(get_config(arch))
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.RandomState(1).randint(0, cfg.vocab, (2, 72)).astype(np.int32))
    full = np.asarray(jax.jit(jm.logits_fn, static_argnums=0)(cfg, params, {"tokens": toks}), np.float32)
    caches, last = jax.jit(jm.prefill, static_argnums=(0, 3))(cfg, params, {"tokens": toks[:, :64]}, 128)
    decode = jax.jit(jm.decode_step, static_argnums=0)
    errs = [float(np.abs(np.asarray(last[:, 0], np.float32) - full[:, 63]).max())]
    for pos in range(64, 71):
        logits, caches = decode(cfg, params, caches, toks[:, pos:pos + 1], jnp.int32(pos))
        errs.append(float(np.abs(np.asarray(logits[:, 0], np.float32) - full[:, pos]).max()))
    top = float(np.abs(full).max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    return {"arch": arch, "layers": cfg.n_layers, "max_logit": top, "max_abs": max(errs),
            "ulps": max(errs) / ulp, "ulps_by_position": [e / ulp for e in errs]}


if __name__ == "__main__":
    for name in sys.argv[1:] or ["qwen1.5-0.5b", "mamba2-370m", "hymba-1.5b"]:
        print(json.dumps(noise(name)), flush=True)
