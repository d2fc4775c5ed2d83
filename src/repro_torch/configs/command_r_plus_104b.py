"""command-r-plus-104b [dense]: GQA, no-bias, parallel attn/MLP blocks, tied
embeddings [hf:CohereForAI/c4ai-command-r-v01].

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12_288,
    vocab=256_000,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33_792,
    mlp_act="swiglu",
    parallel_block=True,
    tie_embeddings=True,
)
