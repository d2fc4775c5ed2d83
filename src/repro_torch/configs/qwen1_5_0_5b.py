"""qwen1.5-0.5b [dense]: QKV bias [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    vocab=151_936,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    mlp_act="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
)
