"""Gallager-style congestion-aware forwarding update (paper Eq. 11).

Each sweep moves forwarding mass at every (application, stage, node) away
from high-marginal-cost out-links toward the minimum-marginal link j*, with
the scale-invariant relative step of the JAX package:

    rate_ij = alpha * (delta_ij - delta_min) / (|delta_min| + delta_ij - delta_min)
    phi_ij <- phi_ij * (1 - rate_ij)                      (j != j*)
    phi_ij* <- mass_i - sum_{j != j*} phi_ij

Blocking rule: improper out-links (q_j >= q_i) drain at the maximal rate
alpha, so every cycle in the phi-support keeps gain < 1 and (I - Phi^T)
stays invertible. Dense and batched over [B, A, K, V].
"""
from __future__ import annotations

import torch

from .marginals import link_marginals
from .structs import BIG_THRESHOLD, Problem, State, forwarding_mass, one_hot

_PRUNE = 1e-9  # forwarding fractions below this are swept into j*


def forwarding_sweep(
    problem: Problem,
    state: State,
    alpha: float = 0.5,
    *,
    solver: str = "neumann",
    mass: torch.Tensor | None = None,
) -> State:
    """One full congestion-aware forwarding sweep (all apps/stages/nodes).

    `mass` (Eq. 2 emission totals) depends only on x and the destinations,
    fixed across the T_phi inner sweeps, so `forwarding_update` passes it."""
    n = problem.net.n_nodes
    delta, aux = link_marginals(problem, state, solver=solver)  # [B, A, K, V, V]
    q = aux["q"]
    if mass is None:
        mass = forwarding_mass(state, problem.apps, n)  # [B, A, K, V]

    delta_min = delta.amin(dim=-1, keepdim=True)
    jstar_oh = one_hot(delta.argmin(dim=-1), n)

    gap = torch.where(delta < BIG_THRESHOLD, delta - delta_min, 0.0)
    del delta
    rate = alpha * (gap / (delta_min.abs() + gap + 1e-12))
    del gap

    # Blocking: improper links (q_j >= q_i) drain at the maximal rate.
    improper = ~(q[..., None, :] < q[..., :, None])
    rate = torch.where(improper, alpha, rate)

    phi = state.phi * (1.0 - rate)
    del rate
    phi = torch.where(phi < _PRUNE, 0.0, phi)

    # Re-assign the freed mass to j*.
    phi = phi * (1.0 - jstar_oh)
    others = phi.sum(dim=-1)
    phi = phi + jstar_oh * torch.clamp_min(mass - others, 0.0)[..., None]
    return State(x=state.x, phi=phi)


def forwarding_update(
    problem: Problem,
    state: State,
    *,
    t_phi: int = 8,
    alpha: float = 0.5,
    solver: str = "neumann",
) -> State:
    """T_phi inner forwarding sweeps (the paper's forwarding subproblem 8),
    with the emission mass hoisted out of the loop."""
    mass = forwarding_mass(state, problem.apps, problem.net.n_nodes)
    for _ in range(t_phi):
        state = forwarding_sweep(problem, state, alpha=alpha, solver=solver, mass=mass)
    return state
