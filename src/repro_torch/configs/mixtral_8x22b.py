"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8) expert d_ff=16384 vocab=32768."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    vocab=32_768,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    n_experts=8,
    top_k=2,
    moe_d_ff=16_384,
    mlp_act="swiglu",
    sliding_window=4096,
    tie_embeddings=False,
)
