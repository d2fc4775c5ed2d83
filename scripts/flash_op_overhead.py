#!/usr/bin/env python3
"""What the flash kernel's dispatcher op costs a call, on the card.

    python3 scripts/flash_op_overhead.py

The kernel is reached three ways at phase 1's flash shapes, in turns
(A B C C B A, five rounds): `_launch` (the kernel launch alone),
`torch.ops.repro_torch.flash_attention` (the op through the dispatcher,
no autograd), and `flash_attention` (the wrapper the model calls: the
launch rules checked, then the op). For each it prints the device ms a call
by CUDA events over back-to-back calls, as chip_smoke.py's phase 1 times
the kernel, and the host us a call takes to return (no synchronisation
inside the 200 calls timed). A route whose host time exceeds the kernel's
device time keeps the device waiting, and its event time is then the host
time. Medians over the rounds. Exits non-zero without a GPU.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402

# (tag, B, H, Kv, S, D, window): phase 1's serve prefill, qwen2-moe's
# D = 128, and hymba's GQA 25:5 with its window; causal, bf16 (wgmma).
SHAPES = (("serve prefill", 8, 16, 16, 1024, 64, None), ("qwen2-moe D=128", 8, 16, 16, 1024, 128, None),
          ("hymba window 1024", 8, 25, 5, 2048, 64, 1024))
ROUNDS, REPS, HOST_CALLS = 5, 20, 200


def host_us(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / HOST_CALLS
    torch.cuda.synchronize()
    return us


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_op_overhead: torch.cuda.is_available() is False; this script needs a GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import ops as fa_ops

    print(chip_smoke.gpu_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for tag, b, h, kv, s, d, window in SHAPES:
        q = torch.randn(b, s, h, d, generator=gen, device="cuda", dtype=torch.bfloat16).transpose(1, 2)
        k = torch.randn(b, s, kv, d, generator=gen, device="cuda", dtype=torch.bfloat16).transpose(1, 2)
        v = torch.randn(b, s, kv, d, generator=gen, device="cuda", dtype=torch.bfloat16).transpose(1, 2)
        routes = {
            "launch": lambda: fa_ops._launch(q, k, v, True, window, 0),
            "op": lambda: torch.ops.repro_torch.flash_attention(q, k, v, True, window, 0),
            "wrapper": lambda: fa_ops.flash_attention(q, k, v, causal=True, window=window),
        }
        if not (torch.equal(routes["launch"](), routes["op"]()) and torch.equal(routes["op"](), routes["wrapper"]())):
            raise AssertionError(f"{tag}: the three routes disagree")
        ms = {r: [] for r in routes}
        us = {r: [] for r in routes}
        with torch.no_grad():
            for i in range(ROUNDS):
                order = list(routes) if i % 2 == 0 else list(routes)[::-1]
                for r in order + order[::-1]:
                    ms[r].append(chip_smoke.cuda_ms(routes[r], REPS))
                    us[r].append(host_us(routes[r]))
        print(json.dumps({"shape": f"{tag}: B={b} H={h} Kv={kv} S={s} D={d} bf16 causal",
                          "device_ms": {r: statistics.median(x) for r, x in ms.items()},
                          "device_ms_range": {r: [min(x), max(x)] for r, x in ms.items()},
                          "host_us_per_call": {r: statistics.median(x) for r, x in us.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
