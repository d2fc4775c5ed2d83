"""Downstream marginal costs q_i^{a,k} and link marginals delta (Eq. 10).

Gallager's cost-to-go: for the final stage

  q^{a,K-1}_i = sum_j phi^{a,K-1}_{ij} (L_{a,K-1} D'_{ij} + q^{a,K-1}_j)

and for every earlier stage the partition-(k+1) host absorbs the stage,
pays the computation marginal kappa and re-injects the next stage:

  q^{a,k}_i = sum_j phi^{a,k}_{ij} (L_{a,k} D'_{ij} + q^{a,k}_j)
              + x^{a,k+1}_i (kappa^{a,k+1}_i + q^{a,k+1}_i)

Each line is a linear fixed point (I - Phi) q = c on the same propagation
path as the traffic solve, walked in reverse stage order. Phantom stages
have phi = 0, kappa = 0 and gate 0, so their cost-to-go is exactly zero.

`round_eval` is the once-per-round evaluation shared by the objective
read-out and the next placement sweep (one traffic solve for both).
All functions take stacked [B, ...] problems and states.
"""
from __future__ import annotations

import torch

from .flow import (
    loads,
    marginal_comp,
    marginal_link_weights,
    objective_from_loads,
    stage_solve,
    stage_traffic,
)
from .structs import BIG, Problem, State, partition_live_mask


def cost_to_go(
    problem: Problem,
    state: State,
    t: torch.Tensor | None = None,
    *,
    solver: str = "neumann",
):
    """Returns (q [B,A,K,V], dp [B,V,V], kappa [B,A,P,V], t [B,A,K,V], F, G)."""
    if t is None:
        t = stage_traffic(problem, state, solver=solver)
    F, G = loads(problem, state, t)
    dp = marginal_link_weights(problem, F)  # BIG off-edges
    dp_edges = torch.where(problem.net.adj > 0, dp, 0.0)  # safe for sums
    kappa = marginal_comp(problem, G)  # [B, A, P, V]
    L = problem.apps.L  # [B, A, K]

    # Absorption gates / marginals of the NEXT partition, stage-aligned:
    # stage k is absorbed by partition k+1 for k < parts; the final and
    # phantom stages have no absorption term.
    live = partition_live_mask(problem.apps)[..., None]  # [B, A, P, 1]
    zeros_tail = torch.zeros_like(state.x[..., :1, :])
    gates = torch.cat([state.x * live, zeros_tail], dim=-2)  # [B, A, K, V]
    kappas = torch.cat([kappa * live, zeros_tail], dim=-2)  # [B, A, K, V]

    n_stages = state.phi.shape[-3]
    q_next = torch.zeros_like(gates[..., 0, :])
    qs = [None] * n_stages
    for k in reversed(range(n_stages)):
        phi_k = state.phi[..., k, :, :]
        link_term = L[..., k, None] * (phi_k * dp_edges[:, None]).sum(dim=-1)
        c = link_term + gates[..., k, :] * (kappas[..., k, :] + q_next)
        q_next = stage_solve(phi_k, c, problem, transpose=False, solver=solver)
        qs[k] = q_next
    q = torch.stack(qs, dim=-2)  # [B, A, K, V]
    return q, dp, kappa, t, F, G


def round_eval(problem: Problem, state: State, *, solver: str = "neumann"):
    """One full marginal evaluation of `state`: (J [B], aux). aux carries the
    objective split and the (q, dp, kappa, t, F, G) tuple the next
    placement sweep consumes."""
    q, dp, kappa, t, F, G = cost_to_go(problem, state, solver=solver)
    J, j_comm, j_comp = objective_from_loads(problem, F, G)
    aux = {"J": J, "J_comm": j_comm, "J_comp": j_comp, "ctg": (q, dp, kappa, t, F, G)}
    return J, aux


def link_marginals(problem: Problem, state: State, *, solver: str = "neumann"):
    """delta^{a,k}_{ij} = L_{a,k} D'_{ij} + q^{a,k}_j [B, A, K, V, V] (Eq. 10),
    BIG on non-edges. Returns (delta, aux)."""
    q, dp, kappa, t, F, G = cost_to_go(problem, state, solver=solver)
    L = problem.apps.L  # [B, A, K]
    delta = L[..., None, None] * dp[:, None, None] + q[..., None, :]
    delta = torch.where(problem.net.adj[:, None, None] > 0, delta, BIG)
    return delta, {"q": q, "dp": dp, "kappa": kappa, "t": t, "F": F, "G": G}
