"""zamba2-2.7b [hybrid, interleaved]: Mamba-2 backbone with a (shared)
attention block applied every 6th layer [arXiv:2411.15242].

54L d_model=2560 32H d_ff=10240 ssm_state=64 vocab=32000. Profile-only:
interleaved stacks are not implemented by the executable substrate
(init_params raises); the partition bridge costs attention vs SSM layers
from hybrid_attn_period."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    vocab=32_000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10_240,
    mlp_act="gelu",
    hybrid_attn_period=6,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    tie_embeddings=True,
)
