"""The plain forwarding sweep update: the CPU path of `ops.update_phi` and
the oracle its kernel is held to on the card
(tests/test_torch_forwarding_sweep_card.py).

Whole tensors of phi's size [B, A, K, V, V]: the link marginals delta, then
the gap, the rate, the blocking mask, the decay, the prune and the one-hot
reassignment to the minimum-marginal link, about 45 passes over phi.
"""
from __future__ import annotations

import torch

from ...core.structs import BIG, BIG_THRESHOLD, one_hot

_PRUNE = 1e-9  # forwarding fractions below this are swept into j*


def link_delta(q, dp, L, adj):
    """delta^{a,k}_{ij} = L_{a,k} D'_{ij} + q^{a,k}_j [B, A, K, V, V] (Eq. 10),
    BIG on non-edges, from q [B, A, K, V], dp [B, V, V], L [B, A, K] and
    the adjacency [B, V, V]."""
    delta = L[..., None, None] * dp[:, None, None] + q[..., None, :]
    return torch.where(adj[:, None, None] > 0, delta, BIG)


def update_phi_ref(phi, q, dp, L, adj, mass, alpha):
    """The new phi of one sweep (see `core.forwarding`) from the old `phi`,
    the cost-to-go q, the link marginals' weights dp (BIG off-edge), the
    stage rates L, the adjacency and the emission mass [B, A, K, V]."""
    delta = link_delta(q, dp, L, adj)
    delta_min = delta.amin(dim=-1, keepdim=True)
    jstar_oh = one_hot(delta.argmin(dim=-1), phi.shape[-1])

    gap = torch.where(delta < BIG_THRESHOLD, delta - delta_min, 0.0)
    del delta
    rate = alpha * (gap / (delta_min.abs() + gap + 1e-12))
    del gap

    # Blocking: improper links (q_j >= q_i) drain at the maximal rate.
    improper = ~(q[..., None, :] < q[..., :, None])
    rate = torch.where(improper, alpha, rate)

    phi = phi * (1.0 - rate)
    del rate
    phi = torch.where(phi < _PRUNE, 0.0, phi)

    # Re-assign the freed mass to j*.
    phi = phi * (1.0 - jstar_oh)
    others = phi.sum(dim=-1)
    return phi + jstar_oh * torch.clamp_min(mass - others, 0.0)[..., None]
