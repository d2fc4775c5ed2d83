"""Congestion-dependent communication / computation costs (paper section II).

M/M/1 queue length D(F) = F/(mu-F), continued past rho_max * mu by the C^1
quadratic extension that matches value, slope and curvature at the knee
(keeps J finite and convex for infeasible iterates), plus the `linear`
kind D = F/mu. `rho_max` may be a float or a `[B]` tensor after stacking;
it is viewed against the load array here.
"""
from __future__ import annotations

import torch

from .structs import CostModel, bview


def _mm1(load, cap, rho_max):
    """Smoothed M/M/1 queue length load/(cap-load) with quadratic tail."""
    cap = torch.clamp_min(cap, 1e-9)
    knee = bview(rho_max, cap.ndim) * cap
    gap = cap - knee
    v = knee / gap
    s = cap / (gap * gap)
    c = 2.0 * cap / (gap * gap * gap)
    d = load - knee
    ext = v + s * d + 0.5 * c * d * d
    safe = torch.minimum(load, knee)  # avoid div-by-~0 in the untaken branch
    base = safe / (cap - safe)
    return torch.where(load <= knee, base, ext)


def _mm1_prime(load, cap, rho_max):
    cap = torch.clamp_min(cap, 1e-9)
    knee = bview(rho_max, cap.ndim) * cap
    gap = cap - knee
    s = cap / (gap * gap)
    c = 2.0 * cap / (gap * gap * gap)
    safe = torch.minimum(load, knee)
    base = cap / torch.square(cap - safe)
    ext = s + c * (load - knee)
    return torch.where(load <= knee, base, ext)


def link_cost(F, mu, cost: CostModel):
    """D_ij(F_ij) elementwise."""
    if cost.kind == "linear":
        return F / torch.clamp_min(mu, 1e-9)
    return _mm1(F, mu, cost.rho_max)


def link_cost_prime(F, mu, cost: CostModel):
    if cost.kind == "linear":
        return 1.0 / torch.clamp_min(mu, 1e-9) * torch.ones_like(F)
    return _mm1_prime(F, mu, cost.rho_max)


def comp_cost(G, nu, cost: CostModel):
    if cost.kind == "linear":
        return G / torch.clamp_min(nu, 1e-9)
    return _mm1(G, nu, cost.rho_max)


def comp_cost_prime(G, nu, cost: CostModel):
    if cost.kind == "linear":
        return 1.0 / torch.clamp_min(nu, 1e-9) * torch.ones_like(G)
    return _mm1_prime(G, nu, cost.rho_max)
