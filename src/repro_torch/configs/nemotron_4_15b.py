"""nemotron-4-15b [dense]: GQA + squared-ReLU MLP [arXiv:2402.16819].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    vocab=256_000,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    mlp_act="relu2",
    tie_embeddings=False,
)
