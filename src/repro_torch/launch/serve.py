"""Serving entry point: batched prefill + decode with slot-based continuous
batching (the JAX package's `launch/serve.py`, on PyTorch).

A fixed pool of B slots runs lockstep decode; finished sequences free their
slot and the scheduler admits queued requests via a fresh prefill of the
whole batch. The slot semantics are JAX's, including its simplifications:
the prefill's own greedy token seeds the first decode step but is not
recorded; when a slot frees up while requests wait, every still-running
request goes back to the front of the queue and the whole batch is
prefilled again, restarting those requests' generation (their first-token
time is kept) with the position reset to the prompt length.

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --reduced \\
        --requests 12 --batch-slots 4 --prompt-len 32 --max-new 16 --device cpu

Every executable arch runs, with the JAX CLI's frontend stripping: a
frontend arch (internvl2-76b) is served as its token backbone. An
encoder-decoder arch raises ValueError before its first prefill: the JAX
CLI strips the frontend and then hands `{"tokens"}` to an encdec prefill,
which reads `batch["dec_tokens"]` and fails with KeyError (ROADMAP.md
section 3); the port does not invent a decoder prompt the reference lacks.

Without `--device cpu` it runs on the GPU (and raises without one). The
JSON summary carries p50/p95 end-to-end latency, p50/p95 time to first
token and decode throughput from the obs metrics registry, plus the raw
registry snapshot under "metrics". REPRO_TRACE=path additionally records
host spans around the prefill/decode loop.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..configs import get_config, reduced_config
from ..device import solve_device
from ..models import decode_step, init_params, prefill
from ..models.config import ModelConfig
from ..models.model import params_device
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .steps import serve_config


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [prompt_len]
    max_new: int
    arrived: float
    started: float | None = None
    tokens: list | None = None
    finished: float | None = None
    # Time the first generated token landed (set once; survives the
    # re-prefill because dataclasses.replace copies it).
    first_token: float | None = None


def serve(
    cfg: ModelConfig,
    params,
    prompts: np.ndarray,
    *,
    batch_slots: int,
    max_new: int,
    max_seq: int,
    device="cuda",
    registry: obs_metrics.MetricsRegistry | None = None,
):
    """Serve every prompt of `prompts` (int [R, prompt_len]) greedily.

    Returns (tokens, summary): the generated tokens of each request in
    request order, and the JSON summary the CLI prints. Metrics go to
    `registry` (default: the process-wide one). Raises ValueError for an
    encoder-decoder `cfg` (module doc)."""
    if cfg.family == "encdec":
        raise ValueError(
            f"serve: {cfg.name!r} is an encoder-decoder; the reference serve loop feeds "
            "{'tokens'} to its prefill, which reads batch['dec_tokens'] and raises "
            "KeyError: 'dec_tokens' (ROADMAP.md section 3). Run prefill/decode_step with "
            "{'feats'|'tokens', 'dec_tokens'}, or the executor's encoder/decoder split"
        )
    dev = solve_device(params_device(params), device)
    registry = obs_metrics.registry if registry is None else registry
    prompts = np.asarray(prompts, np.int32)
    n_req, prompt_len = prompts.shape
    queue = [
        Request(rid=i, prompt=prompts[i], max_new=max_new, arrived=time.perf_counter())
        for i in range(n_req)
    ]
    b = batch_slots
    active: list[Request | None] = [None] * b
    caches = None
    cur_tokens = np.zeros((b, 1), np.int32)
    pos = prompt_len
    done: list[Request] = []
    decode_steps = 0
    t0 = time.perf_counter()

    def admit():
        nonlocal caches, cur_tokens, pos
        free = [i for i, r in enumerate(active) if r is None]
        if not free or not queue:
            return
        # Lockstep batch: admit up to all free slots at once with a batched
        # prefill (empty slots run a dummy prompt).
        admitted = 0
        for i in free:
            if queue:
                r = queue.pop(0)
                r.started = time.perf_counter()
                r.tokens = []
                active[i] = r
                admitted += 1
        batch = np.stack([
            active[i].prompt if active[i] is not None else np.zeros(prompt_len, np.int32)
            for i in range(b)
        ])
        with obs_trace.span("serve.prefill", admitted=admitted):
            caches, logits = prefill(cfg, params, {"tokens": torch.from_numpy(batch).to(dev)}, max_seq)
            # Greedy: the first maximum, as jnp.argmax.
            cur_tokens = logits[:, -1, :].argmax(-1).to(torch.int32).cpu().numpy()[:, None]
        pos = prompt_len

    with torch.inference_mode(), obs_trace.span("serve.run", requests=n_req, slots=b):
        admit()
        while any(r is not None for r in active) or queue:
            with obs_trace.span("serve.decode", pos=pos):
                logits, caches = decode_step(cfg, params, caches, torch.from_numpy(cur_tokens).to(dev), pos)
                nxt = logits[:, 0, :].argmax(-1).to(torch.int32).cpu().numpy()
            decode_steps += 1
            pos += 1
            finished_any = False
            for i, r in enumerate(active):
                if r is None:
                    continue
                r.tokens.append(int(nxt[i]))
                if r.first_token is None:
                    r.first_token = time.perf_counter()
                if len(r.tokens) >= r.max_new or pos >= max_seq - 1:
                    r.finished = time.perf_counter()
                    done.append(r)
                    active[i] = None
                    finished_any = True
            cur_tokens = nxt[:, None]
            if finished_any and queue:
                # Re-prefill the whole batch when slots free up (a real
                # engine would splice requests in with paged attention).
                for i, r in enumerate(active):
                    if r is not None:
                        queue.insert(0, dataclasses.replace(r))
                        active[i] = None
                admit()

    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.tokens) for r in done)

    # The percentiles the summary reports are computed from the histogram
    # snapshot, so the CLI and any metrics consumer can never disagree.
    lat_hist = registry.histogram("serve.latency_s")
    ttft_hist = registry.histogram("serve.ttft_s")
    for r in done:
        lat_hist.observe(r.finished - r.arrived)
        if r.first_token is not None:
            ttft_hist.observe(r.first_token - r.arrived)
    registry.counter("serve.requests").inc(len(done))
    decode_tps = total_tokens / dt
    registry.gauge("serve.decode_tokens_per_s").set(decode_tps)
    lat_snap = lat_hist.snapshot()
    ttft_snap = ttft_hist.snapshot()
    summary = {
        "requests": len(done),
        "decode_steps": decode_steps,
        "generated_tokens": total_tokens,
        "tokens_per_s": round(total_tokens / dt, 2),
        "decode_tokens_per_s": round(decode_tps, 2),
        "mean_latency_s": round(lat_snap["mean"], 3),
        "p50_latency_s": round(lat_snap["p50"], 3),
        "p95_latency_s": round(lat_snap["p95"], 3),
        "p50_ttft_s": round(ttft_snap["p50"], 3),
        "p95_ttft_s": round(ttft_snap["p95"], 3),
        "metrics": {
            k: (
                {kk: round(vv, 4) for kk, vv in v.items()}
                if isinstance(v, dict)
                else round(v, 4) if isinstance(v, float) else v
            )
            for k, v in registry.snapshot().items()
        },
    }
    tokens = [r.tokens for r in sorted(done, key=lambda r: r.rid)]
    return tokens, summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    obs_trace.maybe_configure_from_env()

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = serve_config(cfg)
    if cfg.frontend != "none" or cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, frontend="none", frontend_dim=0)
    params = init_params(cfg, args.seed, device=args.device)

    rng = np.random.RandomState(args.seed)
    prompts = np.stack([
        rng.randint(0, cfg.vocab, size=args.prompt_len).astype(np.int32)
        for _ in range(args.requests)
    ])
    _, summary = serve(
        cfg, params, prompts, batch_slots=args.batch_slots, max_new=args.max_new,
        max_seq=args.max_seq, device=args.device,
    )
    print(json.dumps(summary), flush=True)
    obs_trace.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
