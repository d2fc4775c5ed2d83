"""qwen2-moe-a2.7b [moe]: 60 routed experts top-4 + shared expert, QKV bias
[hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) expert d_ff=1408 shared d_ff=5632 vocab=151936."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    vocab=151_936,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    n_experts=60,
    top_k=4,
    moe_d_ff=1408,
    shared_d_ff=5632,
    mlp_act="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
)
