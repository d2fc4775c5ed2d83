"""mamba2-370m [ssm]: SSD / state-space duality, attention-free
[arXiv:2405.21060].

48L d_model=1024 vocab=50280 ssm_state=128 (d_inner=2048, 32 heads of 64)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    vocab=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    tie_embeddings=True,
)
