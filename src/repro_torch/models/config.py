"""Model configuration for the architecture zoo (a copy of the JAX
package's `models/config.py`, minus its `use_pallas_attention` switch: in
the port the device decides, a CUDA tensor runs the flash kernel).

One frozen dataclass covers all five families:
  dense   – standard decoder-only transformer (GQA/MQA, MLP variants)
  moe     – dense attention + mixture-of-experts FFN (top-k, shared experts)
  ssm     – attention-free Mamba-2 / SSD stack
  hybrid  – Hymba-style parallel attention + SSM heads per block
  encdec  – encoder-decoder (Seamless backbone)
vlm/audio archs are a dense/encdec backbone plus a stub modality frontend
(precomputed patch/frame embeddings enter through a learned projector).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int | None = None  # tokens; None = full attention
    parallel_block: bool = False  # command-r style attn ∥ mlp
    # mlp
    d_ff: int = 0
    mlp_act: str = "swiglu"  # swiglu | geglu | relu2 | gelu
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0  # qwen2-moe shared expert (0 = none)
    capacity_factor: float = 1.25
    # MoE dispatch groups (launcher sets = number of data shards so each DP
    # shard dispatches locally; 0/1 = single global dispatch).
    moe_groups: int = 0
    # ssm (mamba2 / hymba SSM branch)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 128
    # hybrid layer mix: 0 = parallel hybrid (hymba — every block computes the
    # attention AND SSM branches); p >= 1 = interleaved — only every p-th
    # block (layer % p == p - 1) is an attention block, the rest are
    # SSM-only. Interleaved configs are profile-only substrate-wise
    # (init_params raises); per-layer costing lives in partition/profile.py.
    hybrid_attn_period: int = 0
    # encdec
    n_dec_layers: int = 0
    # modality frontend stub ("none" | "patch" | "frames")
    frontend: str = "none"
    frontend_dim: int = 0
    # misc
    embed_scale: bool = False  # gemma: embeddings * sqrt(d)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # dtypes (strings to stay hashable/static)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # execution knobs
    remat: bool = True
    quantize_int8: bool = False  # weight-only int8 storage (serving)
    # loss
    vocab_chunking: int = 0  # 0 = unchunked cross-entropy

    # ---- derived ----
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def attends(self) -> bool:
        return self.family in ("dense", "moe", "hybrid", "encdec")

    def layer_mix(self, layer: int) -> tuple[bool, bool]:
        """(has_attention, has_ssm) for block `layer` (0-indexed).

        Uniform-stack families return the same pair for every layer; an
        interleaved hybrid (hybrid_attn_period >= 1) alternates block types,
        so per-layer FLOP/param accounting must ask per layer."""
        if self.family == "hybrid" and self.hybrid_attn_period >= 1:
            p = self.hybrid_attn_period
            is_attn = layer % p == p - 1
            return is_attn, not is_attn
        return self.attends, self.family in ("ssm", "hybrid")

    def n_attn_layers(self) -> int:
        """How many blocks carry an attention branch."""
        if self.family == "hybrid" and self.hybrid_attn_period >= 1:
            return sum(
                1 for l in range(self.n_layers) if self.layer_mix(l)[0]
            )
        return self.n_layers if self.attends else 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context (constant/bounded state)?"""
        if self.family == "ssm":
            return True
        if self.family == "encdec":
            return False
        return self.sliding_window is not None

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += d * v
        if self.frontend != "none":
            total += self.frontend_dim * d
        attn_p = mix_p = ssm_p = 0
        if self.family in ("dense", "moe", "hybrid", "encdec"):
            h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
            attn_p += d * h * hd + 2 * d * kv * hd + h * hd * d  # qkvo
        if self.family in ("dense", "hybrid", "encdec"):
            mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
            mix_p += mult * d * self.d_ff
        if self.family == "moe":
            mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
            mix_p += d * self.n_experts  # router
            mix_p += self.n_experts * mult * d * self.moe_d_ff
            if self.shared_d_ff:
                mix_p += mult * d * self.shared_d_ff
        if self.family in ("ssm", "hybrid"):
            din, n, nh = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            ssm_p += d * (2 * din + 2 * n + nh)  # in_proj (z,x,B,C,dt)
            ssm_p += self.conv_width * (din + 2 * n)  # conv
            ssm_p += 3 * nh  # A_log, D, dt_bias
            ssm_p += din * d  # out_proj
        if self.family == "hybrid" and self.hybrid_attn_period >= 1:
            # Interleaved: attention params only on attention blocks, SSM
            # params only on the rest; MLP in every block.
            na = self.n_attn_layers()
            total += na * attn_p + (self.n_layers - na) * ssm_p
            total += self.n_layers * mix_p
        else:
            total += self.n_layers * (attn_p + mix_p + ssm_p)
        if self.family == "encdec":
            # decoder: self-attn + cross-attn + mlp
            h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
            dec = 2 * (d * h * hd + 2 * d * kv * hd + h * hd * d)
            mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
            dec += mult * d * self.d_ff
            total += self.n_dec_layers * dec
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE counts only routed top_k experts)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
        expert_p = mult * d * self.moe_d_ff
        inactive = self.n_layers * (self.n_experts - self.top_k) * expert_p
        return self.n_params() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a valid dry-run cell, with the skip reason."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention (DESIGN.md section 4)"
    return True, ""
