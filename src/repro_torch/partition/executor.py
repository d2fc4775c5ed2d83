"""Execute a 2-partition split of an actual model: the data plane of Fig. 1
(the JAX package's `partition/executor.py`).

Partition 1 = embedding (or the modality frontend) + layers [0, k);
partition 2 = layers [k, L) + final norm + unembed. The intermediate
activation (the paper's stage-1 traffic, S * d * 2 bytes a sequence in
bf16) is exactly what `run_partition(..., part=1)` returns and `part=2`
consumes. For encoder-decoder models the split is encoder / decoder:
partition 1 returns the encoder's memory, and partition 2 takes
{"memory", "dec_tokens"}. The split layer k is an argument (the Pareto
sweep of `partition/pareto.py` picks it).
"""
from __future__ import annotations

from ..device import solve_device
from ..models import layers as L
from ..models import model as M
from ..models.config import ModelConfig
from ..models.model import ParamTree, params_device


def split_params(cfg: ModelConfig, params: ParamTree, k: int):
    """Split the model at layer boundary k (ignored for encdec, which splits
    encoder / decoder) into two `ParamTree`s that share the original
    parameters (nothing is copied)."""
    if cfg.family == "encdec":
        p1 = ParamTree({"embed": params.embed, "blocks": list(params.blocks),
                        "enc_final_norm": params.enc_final_norm})
        p2 = ParamTree({"embed": params.embed, "dec_blocks": list(params.dec_blocks),
                        "final_norm": params.final_norm})
        return p1, p2
    if not 0 <= k <= cfg.n_layers:
        raise ValueError(f"split layer {k} outside 0..{cfg.n_layers}")
    blocks = list(params.blocks)
    p1 = ParamTree({"embed": params.embed, "blocks": blocks[:k]})
    p2 = ParamTree({"embed": params.embed, "blocks": blocks[k:], "final_norm": params.final_norm})
    return p1, p2


def run_partition(cfg: ModelConfig, part_params: ParamTree, batch_or_act, *, part: int,
                  device="cuda"):
    """Run one partition on `device`, where its parameters must live.
    part=1 consumes the batch and returns the stage-1 activation [B, S, d]
    (the memory, for encdec); part=2 consumes that activation ({"memory",
    "dec_tokens"} for encdec) and returns the logits [B, S, vocab]."""
    if part not in (1, 2):
        raise ValueError(f"part must be 1 or 2, got {part}")
    solve_device(params_device(part_params), device)
    if cfg.family == "encdec":
        if part == 1:
            return M.encode(cfg, part_params, batch_or_act)
        y, _ = M.decode_stack(cfg, part_params, batch_or_act["memory"], batch_or_act["dec_tokens"])
        return L.unembed(part_params.embed, L.rmsnorm(y, part_params.final_norm, cfg.norm_eps), cfg)
    kind = M._block_kind(cfg)
    if part == 1:
        x = M._embed_input(cfg, part_params, batch_or_act)
        x, _ = M.stack_full(part_params.blocks, x, cfg, kind)
        return x
    x, _ = M.stack_full(part_params.blocks, batch_or_act, cfg, kind)
    x = L.rmsnorm(x, part_params.final_norm, cfg.norm_eps)
    return L.unembed(part_params.embed, x, cfg)
