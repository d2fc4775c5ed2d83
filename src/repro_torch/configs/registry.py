"""Architecture registry: --arch <id> resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
}

# Profile-only additions: interleaved hybrids whose layer mix the partition
# bridge can cost (hybrid_attn_period) but the executable substrate does not
# implement (init_params raises). They complete the 12-config zoo the
# split-point Pareto search sweeps (DESIGN.md section 17) without entering
# ARCHS — the dry-run / smoke matrices iterate executable archs only.
_PROFILE_ONLY = {
    "nemotron-h-8b": "repro_torch.configs.nemotron_h_8b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}

ARCHS = tuple(_MODULES)
ZOO = ARCHS + tuple(_PROFILE_ONLY)


def get_config(name: str) -> ModelConfig:
    module = _MODULES.get(name) or _PROFILE_ONLY.get(name)
    if module is None:
        raise KeyError(f"unknown arch {name!r}; available: {ZOO}")
    return importlib.import_module(module).CONFIG


def reduced_config(name: str) -> ModelConfig:
    """Same-family tiny config for CPU smoke tests: few layers, narrow width,
    few experts, tiny vocab — exercises the identical code paths."""
    cfg = get_config(name)
    kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0
    heads = 4 if cfg.n_heads else 0
    updates = dict(
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=128,
        vocab=512,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=32 if cfg.n_heads else 0,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        frontend_dim=48 if cfg.frontend != "none" else 0,
        remat=False,
    )
    if cfg.family == "moe":
        updates.update(
            n_experts=min(cfg.n_experts, 8),
            top_k=min(cfg.top_k, 2),
            moe_d_ff=64,
            shared_d_ff=64 if cfg.shared_d_ff else 0,
        )
    if cfg.family in ("ssm", "hybrid"):
        updates.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
    if cfg.family == "encdec":
        updates.update(n_dec_layers=2)
    if cfg.sliding_window is not None:
        updates.update(sliding_window=32)
    return dataclasses.replace(cfg, **updates)
