#!/usr/bin/env python3
"""What `chip_smoke.py` phase 10's bf16 prefill-then-decode check reads
for the deep SSM stacks, as the port runs them and with two lower-precision
controls: the SSM cache's recurrent state stored in bf16 (after the prefill
and after every decode step) where the port keeps it in float32, and the
SSD dual form on bf16 operands with a bf16 output. Prints one
JSON line an arch and variant: the largest difference over the compared
positions in bf16 ulps of the largest logit, beside phase 10's limit
(`chip_smoke.BF16_ULPS`).

    python3 scripts/bf16_gate_control.py [arch ...]

Full width and depth, the serve config (bf16 parameters and compute),
random weights from seed 0, on one GPU (about a minute an arch).
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402


def reading(cfg, params, batch) -> dict:
    res = chip_smoke._prefill_decode_gap(dataclasses.replace(cfg, compute_dtype="bfloat16"), params, batch)
    return {k: res[k] for k in ("ulps", "max_abs", "max_logit", "compared")}


def bf16_state(model, ssm):
    """Patch the port so every SSM state it caches is rounded to bf16;
    returns the undo."""
    decode, prefill_cache = ssm.ssm_decode, model._ssm_prefill_cache

    def rounded(cache):
        return {**cache, "state": cache["state"].bfloat16().float()}

    def ssm_decode(p, x, cache, cfg):
        y, new = decode(p, x, cache, cfg)
        return y, rounded(new)

    ssm.ssm_decode = ssm_decode
    model._ssm_prefill_cache = lambda conv_in, state, cfg: rounded(prefill_cache(conv_in, state, cfg))

    def undo():
        ssm.ssm_decode, model._ssm_prefill_cache = decode, prefill_cache
    return undo


def bf16_ssd(ssm):
    """Patch the port so the SSD dual form (forward and prefill) takes its
    operands rounded to bf16 and returns its output rounded to bf16, as a
    bf16 kernel would; returns the undo."""
    ssd = ssm.ssd_chunked

    def ssd_chunked(xs, dt, A, B, C, chunk, init_state=None):
        r = [t.bfloat16().float() for t in (xs, dt, B, C)]
        y, s = ssd(r[0], r[1], A, r[2], r[3], chunk, init_state)
        return y.bfloat16().float(), s

    ssm.ssd_chunked = ssd_chunked

    def undo():
        ssm.ssd_chunked = ssd
    return undo


def main(archs) -> int:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import serve_config
    from repro_torch.models import init_params, model, ssm

    if not torch.cuda.is_available():
        print("bf16_gate_control: needs a GPU", file=sys.stderr)
        return 2
    print(chip_smoke.gpu_line(), flush=True)
    for arch in archs:
        cfg = serve_config(get_config(arch))
        params = init_params(cfg, 0, device="cuda")
        batch = chip_smoke.family_batch(cfg, np.random.RandomState(1), 2, 72, 256)
        line = {"arch": arch, "limit_ulps": chip_smoke.BF16_ULPS.get(arch, 4.0),
                "reference_ulps": chip_smoke.REFERENCE_BF16_ULPS.get(arch)}
        line["port"] = reading(cfg, params, batch)
        for name, patch in (("control_bf16_state", lambda: bf16_state(model, ssm)),
                            ("control_bf16_ssd", lambda: bf16_ssd(ssm))):
            undo = patch()
            try:
                line[name] = reading(cfg, params, batch)
            finally:
                undo()
        print(json.dumps(line), flush=True)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["mamba2-370m", "hymba-1.5b"]))
