"""seamless-m4t-medium [audio]: encoder-decoder multimodal backbone
[arXiv:2308.11596].

12L encoder + 12L decoder, d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
The speech frontend is a STUB per the assignment: input_specs() provides
precomputed 80-dim filterbank frame embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    n_dec_layers=12,
    d_model=1024,
    vocab=256_206,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    mlp_act="gelu",
    frontend="frames",
    frontend_dim=80,
    tie_embeddings=True,
)
