"""Training entry point: the train loop with fault tolerance (the JAX
package's `launch/train.py`).

  * checkpoint every --ckpt-every steps (atomic, keep-K); --resume restarts
    from the latest checkpoint, the data-stream position included, and
    prints "resumed from step N"
  * SIGTERM/SIGINT (preemption) checkpoint at step + 1 and exit 0
  * device-agnostic restore: a checkpoint from the card restores on the
    CPU and back (checkpoint/)
  * metrics JSONL for monitoring (--metrics)

Flags and output lines are the JAX CLI's, plus --device (default "cuda",
which raises without a GPU). Under a launcher of more than one process
(one process a device, the group joined by `launch.mesh.init_from_env`)
or with --model-parallel other than 1, the step runs over
`build_mesh(--model-parallel)`, a ("data", "model") mesh of the world:
every rank draws the same global batch and lays it out over "data",
parameters and AdamW moments are laid out by the sharding rules, the step
runs under `activation_sharding`, and rank 0 alone prints, writes metrics
and writes checkpoints (every rank joins the save's gathers).
--model-parallel that does not divide the world raises ValueError before
any step. One process with --model-parallel 1, under a launcher or not,
runs the plain step on its one device. Frontend archs train as their token
backbone, as the JAX CLI does; an encoder-decoder raises ValueError, where
the JAX CLI fails at the first step with KeyError 'dec_tokens' (its loss
needs decoder tokens the LM stream does not provide).

Examples (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced \\
      --steps 8 --global-batch 4 --seq-len 64 --ckpt-dir /tmp/ck --device cpu
  PYTHONPATH=src OMP_NUM_THREADS=1 python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced \\
      --model-parallel 2 --steps 8 --global-batch 4 --seq-len 32 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import get_config, reduced_config
from ..data import DataConfig, make_pipeline
from ..device import resolve_device
from ..distributed.sharding import ShardingRules, distribute_batch, distribute_params, param_pspecs
from ..models import init_params, trainable
from ..optim import adamw_init
from . import steps as St
from .mesh import MeshShape, build_mesh, init_from_env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family == "encdec":
        raise ValueError(
            f"train: {cfg.name} is an encoder-decoder, whose loss needs decoder tokens "
            "('dec_tokens') beside the encoder input; the LM data stream gives tokens only "
            "(the JAX train CLI fails here with KeyError 'dec_tokens'; ROADMAP.md section 3)"
        )
    if cfg.frontend != "none":
        # The LM-style trainer trains the token backbone, as the JAX CLI does.
        cfg = dataclasses.replace(cfg, frontend="none", frontend_dim=0)
    dev = resolve_device(args.device)
    rank = init_from_env(dev)
    mesh = rules = None
    if (dist.is_initialized() and dist.get_world_size() > 1) or args.model_parallel != 1:
        mesh, rules = build_mesh(args.model_parallel, dev), ShardingRules()
    say = print if rank == 0 else (lambda *a, **k: None)

    params = init_params(cfg, args.seed, device=dev)
    if mesh is not None:
        distribute_params(params, mesh, param_pspecs(cfg, params, MeshShape.of(mesh), rules))
    opt = adamw_init(trainable(params))
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.global_batch,
                          seed=1234 + args.seed)
    pipeline = make_pipeline(data_cfg)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        tree, extra, start_step = ckpt.restore(None, {"params": params, "opt": opt}, device=dev)
        params.load_state_dict(tree["params"])
        opt = tree["opt"]
        pipeline = make_pipeline(data_cfg, extra["data"])
        say(f"resumed from step {start_step}", flush=True)

    step_fn = St.make_train_step(cfg, lr=args.lr, microbatches=args.microbatches, mesh=mesh, rules=rules)
    metrics_path = Path(args.metrics) if args.metrics and rank == 0 else None
    stop = {"now": False}

    def _preempt(signum, frame):
        stop["now"] = True

    def save(step):
        if ckpt:
            ckpt.save(step, {"params": params, "opt": opt}, extra={"data": pipeline.state()})

    previous = {s: signal.signal(s, _preempt) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        losses = []
        t_start = time.time()
        for step in range(start_step, args.steps):
            batch = {"tokens": torch.from_numpy(pipeline.next_batch()).to(dev)}
            if mesh is not None:
                batch = distribute_batch(batch, mesh, rules)
            params, opt, m = step_fn(params, opt, batch)
            loss = float(m["loss"])
            losses.append(loss)
            if step % args.log_every == 0:
                line = {
                    "step": step, "loss": round(loss, 4),
                    "grad_norm": round(float(m["grad_norm"]), 4),
                    "elapsed_s": round(time.time() - t_start, 1),
                }
                say(json.dumps(line), flush=True)
                if metrics_path:
                    with open(metrics_path, "a") as f:
                        f.write(json.dumps(line) + "\n")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            if stop["now"]:
                say("preemption signal: checkpointing and exiting", flush=True)
                save(step + 1)
                return 0
        if ckpt:
            save(args.steps)
        n = max(1, len(losses) // 5)
        say(
            f"done: first-5-avg={np.mean(losses[:n]):.4f} "
            f"last-5-avg={np.mean(losses[-n:]):.4f}",
            flush=True,
        )
        return 0
    finally:
        for s, h in previous.items():
            signal.signal(s, h)


if __name__ == "__main__":
    raise SystemExit(main())
