"""Execute a 2-partition split of an actual model: the data plane of Fig. 1
(the dense part of the JAX package's `partition/executor.py`).

Partition 1 = embedding + layers [0, k); partition 2 = layers [k, L) +
final norm + unembed. The intermediate activation (the paper's stage-1
traffic, S * d * 2 bytes a sequence in bf16) is exactly what
`run_partition(..., part=1)` returns and `part=2` consumes. The split layer
k is an argument: the profile that picks it is not ported yet. The
encoder-decoder split waits for its family.
"""
from __future__ import annotations

from ..device import solve_device
from ..models import layers as L
from ..models.config import ModelConfig
from ..models.model import ParamTree, params_device, require_dense, stack_full


def split_params(cfg: ModelConfig, params: ParamTree, k: int):
    """Split the model at layer boundary k into two `ParamTree`s that share
    the original parameters (nothing is copied)."""
    require_dense(cfg)
    if not 0 <= k <= cfg.n_layers:
        raise ValueError(f"split layer {k} outside 0..{cfg.n_layers}")
    blocks = list(params.blocks)
    p1 = ParamTree({"embed": params.embed, "blocks": blocks[:k]})
    p2 = ParamTree({"embed": params.embed, "blocks": blocks[k:], "final_norm": params.final_norm})
    return p1, p2


def run_partition(cfg: ModelConfig, part_params: ParamTree, batch_or_act, *, part: int,
                  device="cuda"):
    """Run one partition on `device`, where its parameters must live.
    part=1 consumes the batch {"tokens": [B, S]} and returns the stage-1
    activation [B, S, d]; part=2 consumes that activation and returns the
    logits [B, S, vocab]."""
    require_dense(cfg)
    solve_device(params_device(part_params), device)
    if part == 1:
        x = L.embed_tokens(part_params.embed, batch_or_act["tokens"], cfg)
        x, _ = stack_full(part_params.blocks, x, cfg)
        return x
    if part != 2:
        raise ValueError(f"part must be 1 or 2, got {part}")
    x, _ = stack_full(part_params.blocks, batch_or_act, cfg)
    x = L.rmsnorm(x, part_params.final_norm, cfg.norm_eps)
    return L.unembed(part_params.embed, x, cfg)
