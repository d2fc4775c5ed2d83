"""What each MoE dispatch chose, for parity checks: every token's experts
and how near the choice came to a tie.

`record_routes()` wraps `layers._moe_dispatch_combine` while it is active
and appends one `Route` a call: each token's top-k experts (ascending) and
the gap between its k-th and (k+1)-th router logit, in bf16 ulps of the
k-th. A gap of at most NEAR_TIE_ULPS is a near-tie: the same products
summed in another order (another device, a decode step against the full
forward, JAX) may pick other experts there. The CPU parity tests and
`chip_smoke.py` phase 10 share this one rule.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from . import layers

NEAR_TIE_ULPS = 4


@dataclass
class Route:
    experts: torch.Tensor  # [T, k] int64, each token's experts ascending, on the CPU
    gap: torch.Tensor  # [T] float32: k-th minus (k+1)-th router logit, bf16 ulps of the k-th, on the CPU

    def near_tie(self) -> torch.Tensor:
        """[T] bool: tokens whose top-k set may flip under rounding noise."""
        return self.gap <= NEAR_TIE_ULPS


def route_of(logits: torch.Tensor, k: int) -> Route:
    """The route of float32 router logits [T, E], E > k, chosen as
    `_moe_dispatch_combine` chooses (a stable descending sort)."""
    top = torch.sort(logits, dim=-1, descending=True, stable=True)
    kth = top.values[:, k - 1]
    ulp = torch.exp2(torch.floor(torch.log2(kth.abs().clamp_min(2.0 ** -126))) - 7)
    return Route(top.indices[:, :k].sort(dim=-1).values.cpu(), ((kth - top.values[:, k]) / ulp).cpu())


@contextlib.contextmanager
def record_routes():
    """Yields the list of `Route`s, one a dispatch, in call order."""
    calls = []
    dispatch = layers._moe_dispatch_combine

    def recording(p, xf, cfg, cap, *rest):
        logits = layers._matmul(xf, p.router, layers.dtype_of(cfg.compute_dtype)).float()
        calls.append(route_of(logits, cfg.top_k))
        return dispatch(p, xf, cfg, cap, *rest)

    layers._moe_dispatch_combine = recording
    try:
        yield calls
    finally:
        layers._moe_dispatch_combine = dispatch
