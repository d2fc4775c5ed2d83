"""hymba-1.5b [hybrid]: parallel attention + Mamba heads per block, sliding
window on the attention branch [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 ssm_state=16 vocab=32001."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    vocab=32_001,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    mlp_act="swiglu",
    sliding_window=1024,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    tie_embeddings=True,
)
