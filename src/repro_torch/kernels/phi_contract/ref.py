"""The plain versions of cost_to_go's two contractions of phi: the CPU path
of `ops.phi_loads` and `ops.phi_link_term`, and the oracles their kernels
are held to on the card (tests/test_torch_phi_contract_card.py).

Stage by stage, each writes a product of phi's size [B, A, V, V] and reads
it back to reduce it.
"""
from __future__ import annotations

import torch


def phi_loads_ref(phi, t, L):
    """Link load F [B, V, V] (Eq. 5) from phi [B, A, K, V, V], the stage
    traffic t [B, A, K, V] and the stage rates L [B, A, K].

    Stages are accumulated sequentially, one fixed-shape contraction per
    step, so the real prefix's float associativity does not depend on the K
    envelope (appended phantom stages are exact-zero addends)."""
    n = phi.shape[-1]
    F = torch.zeros(t.shape[:-3] + (n, n), dtype=t.dtype, device=t.device)
    for k in range(phi.shape[-3]):
        f_k = t[..., k, :, None] * phi[..., k, :, :]  # [B, A, V, V] (Eq. 4)
        F = F + torch.einsum("ba,baij->bij", L[..., k], f_k)
    return F


def phi_link_term_ref(phi, dp, L):
    """The link term L_{a,k} sum_j phi^{a,k}_{ij} dp_{ij} [B, A, K, V] of
    the cost-to-go (Eq. 10) from phi [B, A, K, V, V], the link marginals dp
    [B, V, V] (0 off the edges) and L [B, A, K], one stage at a time."""
    return torch.stack(
        [L[..., k, None] * (phi[..., k, :, :] * dp[:, None]).sum(dim=-1) for k in range(phi.shape[-3])],
        dim=-2,
    )
