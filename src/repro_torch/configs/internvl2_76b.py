"""internvl2-76b [vlm]: InternViT + InternLM2 backbone [arXiv:2404.16821].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. The ViT frontend is
a STUB per the assignment: input_specs() provides precomputed patch
embeddings (InternViT-6B output dim 3200) which enter through a learned
projector; the transformer backbone is exercised in full.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="dense",
    n_layers=80,
    d_model=8192,
    vocab=128_256,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    mlp_act="swiglu",
    tie_embeddings=False,
    frontend="patch",
    frontend_dim=3200,
)
