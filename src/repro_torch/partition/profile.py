"""Bridge between the model zoo and the paper's optimizer (the JAX
package's `partition/profile.py`, on PyTorch).

Every architecture enters problem (7) as an `ArchProfile`: K = P + 1 stage
packet sizes (stage 0 raw input, stages 1..P-1 split-point activations,
stage P final output) and P per-request partition workloads in FLOPs. The
optimizer core is stage-generic (any P — DESIGN.md section 13) and so is
this bridge: `profile_arch` accepts an arbitrary strictly-ascending cut set
(`splits=`, every interior layer boundary is a legal cut), and
`enumerate_candidates` emits the per-architecture candidate family (every
cut point x P in {1..4}) that the split-point Pareto search in
partition/pareto.py solves as one batched fleet (DESIGN.md section 17).
This is the "directly measured from a test run" quantity of the paper's
Eq. (6) — here derived analytically from the architecture config. The
arithmetic is Python floats and numpy, cast to float32 once where `Apps`
is built, so profiles and `Apps` are bitwise the JAX package's.

Split-point conventions (DESIGN.md sections 4 and 17):
  * decoder-only families: cut after layer boundary k in 1..n_layers-1
    (default L/4 — the paper's "first partition acts as a local compression
    stage"); the shipped activation is the bf16 hidden state.
  * encoder-decoder: any boundary in 1..n_enc+n_dec-1 (layers indexed
    encoder-first); the default is the encoder/decoder boundary, where the
    shipped packet is the encoder memory. A cut inside the decoder ships
    the decoder hidden states AND the memory (cross-attention reads it
    downstream).
  * interleaved hybrids (hybrid_attn_period >= 1): per-partition FLOPs sum
    the per-layer-type table (attention blocks vs SSM blocks), not a
    uniform per-layer constant.
Per-family nuances are only in how the profile is computed (MoE: active
FLOPs; SSM/hybrid: stateless requests ship only layer activations).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ..core.structs import Apps
from ..device import resolve_device
from ..models.config import ModelConfig


def _bytes_per_token_input(cfg: ModelConfig) -> float:
    if cfg.frontend != "none":
        return cfg.frontend_dim * 2.0  # bf16 patch/frame embeddings
    return 4.0  # int32 token ids


def flops_per_token_layer(
    cfg: ModelConfig,
    ctx_len: int,
    decoder: bool = False,
    layer: int | None = None,
) -> float:
    """Forward FLOPs per token for one layer (2 x MACs convention).

    `layer` selects the block index for architectures whose blocks differ —
    interleaved hybrids carry an attention branch only every
    `hybrid_attn_period`-th block and an SSM branch otherwise. Uniform
    stacks ignore it; an interleaved hybrid with layer=None raises, because
    there is no single "the" per-layer cost to return.
    """
    d = cfg.d_model
    has_attn = cfg.attends
    has_ssm = cfg.family in ("ssm", "hybrid")
    if cfg.family == "hybrid" and cfg.hybrid_attn_period >= 1:
        if layer is None:
            raise ValueError(
                f"flops_per_token_layer: {cfg.name!r} is an interleaved "
                f"hybrid (hybrid_attn_period={cfg.hybrid_attn_period}); "
                "pass layer= — attention and SSM blocks cost differently"
            )
        has_attn, has_ssm = cfg.layer_mix(layer)
    f = 0.0
    if has_attn:
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        f += 2.0 * (d * h * hd + 2 * d * kv * hd + h * hd * d)  # qkvo proj
        eff_ctx = min(ctx_len, cfg.sliding_window or ctx_len)
        f += 4.0 * eff_ctx * h * hd  # scores + values
        if decoder:  # cross attention
            f += 2.0 * (d * h * hd + h * hd * d) + 4.0 * ctx_len * h * hd
    if cfg.family in ("dense", "hybrid", "encdec"):
        mult = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
        f += 2.0 * mult * d * cfg.d_ff
    if cfg.family == "moe":
        mult = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
        f += 2.0 * cfg.top_k * mult * d * cfg.moe_d_ff  # active experts only
        if cfg.shared_d_ff:
            f += 2.0 * mult * d * cfg.shared_d_ff
        f += 2.0 * d * cfg.n_experts  # router
    if has_ssm:
        din, n, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        f += 2.0 * d * (2 * din + 2 * n + nh)  # in_proj
        f += 2.0 * cfg.conv_width * (din + 2 * n)  # conv
        f += 2.0 * 2.0 * din * n  # state update + readout (per token)
        f += 2.0 * din * d  # out_proj
    return f


def total_profile_layers(cfg: ModelConfig) -> int:
    """Layer count along the cut axis (encdec: encoder then decoder)."""
    return cfg.n_layers + (cfg.n_dec_layers if cfg.family == "encdec" else 0)


def layer_flops_table(cfg: ModelConfig, seq_len: int) -> list[float]:
    """Per-layer forward FLOPs/token, indexed along the cut axis."""
    if cfg.family == "encdec":
        enc = [
            flops_per_token_layer(cfg, seq_len) for _ in range(cfg.n_layers)
        ]
        dec = [
            flops_per_token_layer(cfg, seq_len, decoder=True)
            for _ in range(cfg.n_dec_layers)
        ]
        return enc + dec
    return [
        flops_per_token_layer(cfg, seq_len, layer=l)
        for l in range(cfg.n_layers)
    ]


def _span_flops(cfg: ModelConfig, seq_len: int, table, lo: int, hi: int):
    """Per-request FLOPs of the partition covering layers [lo, hi)."""
    vals = table[lo:hi]
    if cfg.family != "encdec" and len(set(vals)) == 1:
        # Uniform stacks multiply — bitwise-identical to the historical
        # seq_len * per_layer * count arithmetic the P=2 pin holds to.
        return seq_len * vals[0] * len(vals)
    return seq_len * sum(vals)


def _cut_bytes(cfg: ModelConfig, seq_len: int, cut: int) -> float:
    """Bytes/request shipped across the boundary after layer `cut`."""
    act = seq_len * cfg.d_model * 2.0  # bf16 hidden states
    if cfg.family == "encdec" and cut > cfg.n_layers:
        # Inside the decoder: the encoder memory travels with the decoder
        # hidden states (downstream cross-attention reads it).
        return 2.0 * act
    return act


@dataclasses.dataclass(frozen=True)
class ArchProfile:
    """One candidate partitioning of one architecture.

    splits  : P-1 strictly-ascending interior cut layers (empty for P=1)
    L_bytes : K = P+1 per-request stage packet sizes
    w_flops : P per-request partition workloads

    The legacy 2-partition field names (L0/L1/L2_bytes, w1/w2_flops,
    split_layer) remain available as properties; at P=2 they are exactly
    the pre-split-search profile.
    """

    arch: str
    splits: tuple[int, ...]
    n_layers_total: int
    seq_len: int
    L_bytes: tuple[float, ...]
    w_flops: tuple[float, ...]

    @property
    def n_parts(self) -> int:
        return len(self.w_flops)

    @property
    def split_layer(self) -> int:
        return self.splits[0] if self.splits else self.n_layers_total

    @property
    def L0_bytes(self) -> float:
        return self.L_bytes[0]

    @property
    def L1_bytes(self) -> float:
        return self.L_bytes[1]

    @property
    def L2_bytes(self) -> float:
        return self.L_bytes[-1]

    @property
    def w1_flops(self) -> float:
        return self.w_flops[0]

    @property
    def w2_flops(self) -> float:
        return self.w_flops[-1]

    @property
    def L(self) -> tuple[float, ...]:
        return self.L_bytes

    @property
    def w(self) -> tuple[float, ...]:
        return self.w_flops

    def compression_ratio(self) -> float:
        """L1/L0 — how much the first partition compresses the stream."""
        if self.L0_bytes <= 0.0:
            raise ValueError(
                f"ArchProfile {self.arch!r}: compression_ratio is undefined "
                f"for L0_bytes={self.L0_bytes!r} <= 0 (empty input stage)"
            )
        return self.L1_bytes / self.L0_bytes


def profile_arch(
    cfg: ModelConfig,
    seq_len: int = 1024,
    n_out_tokens: int = 32,
    split: int | None = None,
    splits: tuple[int, ...] | None = None,
) -> ArchProfile:
    """Derive the paper's (L_{a,k}, w^{a,p}) from an architecture config.

    split  : single interior cut layer (P=2 shorthand); valid range is
             1..total_layers-1 for every family — including encdec, whose
             layers are indexed encoder-first (the historical code silently
             ignored split= there).
    splits : arbitrary strictly-ascending cut set; () profiles the
             unsplit P=1 chain. Mutually exclusive with split=.
    Defaults: decoder-only families cut at max(1, n_layers // 4); encdec
    cuts at the encoder/decoder boundary.
    """
    if split is not None and splits is not None:
        raise ValueError(
            "profile_arch: pass split= (single cut) or splits= (cut set), "
            "not both"
        )
    total = total_profile_layers(cfg)
    if splits is None:
        if split is not None:
            splits = (int(split),)
        elif cfg.family == "encdec":
            splits = (cfg.n_layers,)  # encoder / decoder boundary
        else:
            splits = (max(1, cfg.n_layers // 4),)
    cuts = tuple(int(s) for s in splits)
    bad = [s for s in cuts if not 1 <= s <= total - 1]
    if bad:
        boundary = (
            f"; the encoder/decoder boundary is layer {cfg.n_layers}"
            if cfg.family == "encdec"
            else ""
        )
        raise ValueError(
            f"profile_arch: cut layer(s) {bad} out of range for "
            f"{cfg.name!r}: valid interior cut layers are 1..{total - 1} "
            f"({total} layers total{boundary})"
        )
    if any(b <= a for a, b in zip(cuts, cuts[1:])):
        raise ValueError(
            f"profile_arch: split set {cuts} must be strictly ascending "
            "(each partition needs at least one layer)"
        )

    table = layer_flops_table(cfg, seq_len)
    bounds = (0,) + cuts + (total,)
    w = [
        _span_flops(cfg, seq_len, table, lo, hi)
        for lo, hi in zip(bounds, bounds[1:])
    ]
    if cfg.family == "encdec":
        w[-1] += 2.0 * n_out_tokens * cfg.d_model * cfg.vocab  # unembed
    else:
        w[-1] += 2.0 * seq_len * cfg.d_model * cfg.vocab  # unembed
    L = [seq_len * _bytes_per_token_input(cfg)]
    L += [_cut_bytes(cfg, seq_len, s) for s in cuts]
    L.append(n_out_tokens * 4.0)
    return ArchProfile(
        cfg.name, cuts, total, seq_len, tuple(L), tuple(w)
    )


def enumerate_candidates(
    cfg: ModelConfig,
    *,
    seq_len: int = 1024,
    n_out_tokens: int = 32,
    parts: tuple[int, ...] = (1, 2, 3, 4),
    max_per_p: int = 16,
) -> tuple[list[ArchProfile], int]:
    """All candidate split profiles for one architecture.

    For each P in `parts`, enumerates cut sets (P-1 interior boundaries out
    of total_layers-1); when a depth has more than `max_per_p` cut sets,
    a deterministic evenly-spaced subsample of the lexicographically-sorted
    combination list is kept (the endpoints — earliest and latest cut sets
    — always survive). Returns (profiles, n_possible): `n_possible` counts
    the full space before subsampling, so callers can report what was
    dropped instead of silently capping (DESIGN.md section 17).
    """
    if max_per_p < 1:
        raise ValueError(f"max_per_p must be >= 1, got {max_per_p}")
    total = total_profile_layers(cfg)
    profiles: list[ArchProfile] = []
    n_possible = 0
    for p in parts:
        if p < 1:
            raise ValueError(f"partition counts must be >= 1, got {p}")
        if p - 1 > total - 1:
            continue  # more cuts than interior boundaries
        combos = list(itertools.combinations(range(1, total), p - 1))
        n_possible += len(combos)
        if len(combos) > max_per_p:
            idx = np.unique(
                np.linspace(0, len(combos) - 1, max_per_p).round().astype(int)
            )
            combos = [combos[i] for i in idx]
        profiles += [
            profile_arch(
                cfg, seq_len=seq_len, n_out_tokens=n_out_tokens, splits=c
            )
            for c in combos
        ]
    return profiles, n_possible


def apps_from_profiles(
    profiles: list[ArchProfile],
    src: np.ndarray,
    dst: np.ndarray,
    lam: np.ndarray,
    *,
    byte_scale: float = 1.0,
    flop_scale: float = 1.0,
    device: str | torch.device = "cuda",
) -> Apps:
    """Build the optimizer's Apps from per-request profiles.

    Profiles of mixed partition depth are padded to the deepest profile's
    stage envelope with inert phantom stages (L = 0, w = 0, `Apps.parts`
    carries each app's true depth — DESIGN.md section 13), so one Apps can
    mix a P=1 chain with P=4 candidates.

    byte_scale converts bytes -> the unit of link capacities mu (e.g. 1e-6
    for links in MB/s); flop_scale converts FLOPs -> the unit of node service
    rates nu (e.g. 1e-9 for GFLOP/s nodes). The tensors are made on
    `device`."""
    dev = resolve_device(device)
    n = len(profiles)
    if n == 0:
        raise ValueError("apps_from_profiles: empty profile list")
    src = np.asarray(src)
    dst = np.asarray(dst)
    lam = np.asarray(lam)
    if not (len(src) == len(dst) == len(lam) == n):
        raise ValueError(
            f"apps_from_profiles: length mismatch — {n} profiles but "
            f"src has {len(src)}, dst has {len(dst)}, lam has {len(lam)} "
            "entries"
        )
    for name, s in (("byte_scale", byte_scale), ("flop_scale", flop_scale)):
        if not np.isfinite(s) or s <= 0:
            raise ValueError(
                f"apps_from_profiles: {name} must be finite and positive, "
                f"got {s!r}"
            )
    n_parts = max(p.n_parts for p in profiles)
    L = np.zeros((n, n_parts + 1), np.float64)
    w = np.zeros((n, n_parts), np.float64)
    parts = np.zeros(n, np.int32)
    for i, p in enumerate(profiles):
        k = p.n_parts
        L[i, :k] = p.L_bytes[:-1]
        L[i, k] = p.L_bytes[-1]  # final stage sits at index `parts`
        w[i, :k] = p.w_flops
        parts[i] = k
    L *= byte_scale
    w *= flop_scale
    return Apps(
        src=torch.tensor(np.asarray(src, np.int64), device=dev),
        dst=torch.tensor(np.asarray(dst, np.int64), device=dev),
        lam=torch.tensor(np.asarray(lam, np.float32), device=dev),
        L=torch.tensor(L.astype(np.float32), device=dev),
        w=torch.tensor(w.astype(np.float32), device=dev),
        parts=torch.tensor(parts.astype(np.int64), device=dev),
    )
