"""gemma-2b [dense]: GeGLU, head_dim=256, MQA (kv=1), scaled embeddings
[arXiv:2403.08295].

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    vocab=256_000,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    mlp_act="geglu",
    embed_scale=True,
    tie_embeddings=True,
)
