"""Gallager-style congestion-aware forwarding update (paper Eq. 11).

Each sweep moves forwarding mass at every (application, stage, node) away
from high-marginal-cost out-links toward the minimum-marginal link j*, with
the scale-invariant relative step of the JAX package:

    rate_ij = alpha * (delta_ij - delta_min) / (|delta_min| + delta_ij - delta_min)
    phi_ij <- phi_ij * (1 - rate_ij)                      (j != j*)
    phi_ij* <- mass_i - sum_{j != j*} phi_ij

Blocking rule: improper out-links (q_j >= q_i) drain at the maximal rate
alpha, so every cycle in the phi-support keeps gain < 1 and (I - Phi^T)
stays invertible. Dense and batched over [B, A, K, V]. After the cost-to-go
the update is `kernels.forwarding.update_phi`: one kernel launch a sweep on
the card, the plain whole-tensor tail on the CPU.
"""
from __future__ import annotations

import torch

from ..kernels.forwarding import ops as sweep_ops
from .marginals import cost_to_go
from .structs import Problem, State, forwarding_mass


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
    q, dp, *_ = cost_to_go(problem, state, solver=solver)
    if mass is None:
        mass = forwarding_mass(state, problem.apps, problem.net.n_nodes)  # [B, A, K, V]
    phi = sweep_ops.update_phi(state.phi, q, dp, problem.apps.L, problem.net.adj, mass, alpha)
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
