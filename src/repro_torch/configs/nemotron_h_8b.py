"""nemotron-h-8b [hybrid, interleaved]: Mamba-2 backbone with an attention
block every 13th layer (4 of 52), relu2 MLPs [arXiv:2504.03624].

52L d_model=4096 32H (GQA kv=8) d_ff=21504 ssm_state=128 vocab=131072.
Profile-only: the executable substrate implements parallel hybrid blocks,
not interleaved stacks (init_params raises), but the partition bridge costs
every layer by its declared type (hybrid_attn_period)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-h-8b",
    family="hybrid",
    n_layers=52,
    d_model=4096,
    vocab=131_072,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=21_504,
    mlp_act="relu2",
    hybrid_attn_period=13,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    tie_embeddings=False,
)
