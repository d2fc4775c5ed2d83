"""Stage-wise traffic flow, link/node loads, and the objective J (Eqs. 3-7).

Per application a and stage k, the node traffic solves

    t^{a,k} = (I - (Phi^{a,k})^T)^{-1} b^{a,k}

with b^{a,0} = lambda_a e_{s_a}, b^{a,k} = x^{a,k} .* t^{a,k-1} for
1 <= k <= parts_a, and 0 on phantom stages. The stage chain is a Python
loop over K. Every function here takes a STACKED problem and state
(leading instance axis B): phi is [B, A, K, V, V], t is [B, A, K, V].

`solver="neumann"` (default) is the hop-capped propagation of
kernels/neumann (the CUDA kernel on the card); `solver="lu"` is the dense
`torch.linalg.solve` reference.
"""
from __future__ import annotations

import torch

from . import costs
from ..kernels.neumann import effective_hops, neumann_solve
from .structs import BIG, Apps, Problem, State, bview, one_hot, partition_live_mask

SOLVERS = ("neumann", "lu")


def stage_solve(
    phi_k: torch.Tensor,
    b: torch.Tensor,
    problem: Problem,
    *,
    transpose: bool,
    solver: str = "neumann",
) -> torch.Tensor:
    """Batched (I - Phi^T) t = b (transpose=True) or (I - Phi) q = c solve.

    phi_k: [..., V, V], b: [..., V]. The transpose is a view: the kernel
    reads phi column-wise instead of copying phi^T."""
    if solver == "lu":
        n = phi_k.shape[-1]
        eye = torch.eye(n, dtype=phi_k.dtype, device=phi_k.device)
        a = eye - (phi_k.mT if transpose else phi_k)
        return torch.linalg.solve(a, b[..., None])[..., 0]
    if solver != "neumann":
        raise ValueError(f"unknown solver {solver!r}; expected one of {SOLVERS}")
    m = phi_k.mT if transpose else phi_k
    hops = effective_hops(problem.hop_bound, problem.net.n_nodes, fixed_loop=True)
    return neumann_solve(m, b, hops=hops)


def _stage_gates(state: State, apps: Apps) -> torch.Tensor:
    """[..., A, K, V] conversion gate of each stage: x^{a,k} for live
    partitions, zero for stage 0 and for phantom stages."""
    gated = state.x * partition_live_mask(apps)[..., None]  # [..., A, P, V]
    return torch.cat([torch.zeros_like(gated[..., :1, :]), gated], dim=-2)


def _traffic_scan(problem, state, inject, *, solver):
    """Forward stage loop: t_k = solve(phi_k, inject_k + gate_k * t_{k-1})."""
    gates = _stage_gates(state, problem.apps)
    t_prev = torch.zeros_like(inject[..., 0, :])
    ts = []
    for k in range(inject.shape[-2]):
        t_prev = stage_solve(
            state.phi[..., k, :, :],
            inject[..., k, :] + gates[..., k, :] * t_prev,
            problem, transpose=True, solver=solver,
        )
        ts.append(t_prev)
    return torch.stack(ts, dim=-2)  # [..., A, K, V]


def _source_injection(problem: Problem) -> torch.Tensor:
    """[..., A, K, V] exogenous stage sources: lambda at s_a on stage 0."""
    apps = problem.apps
    b0 = apps.lam[..., None] * one_hot(apps.src, problem.net.n_nodes)  # [..., A, V]
    rest = torch.zeros(
        b0.shape[:-1] + (apps.L.shape[-1] - 1, b0.shape[-1]), dtype=b0.dtype, device=b0.device
    )
    return torch.cat([b0[..., None, :], rest], dim=-2)


def stage_traffic(problem: Problem, state: State, *, solver: str = "neumann") -> torch.Tensor:
    """[B, A, K, V] traffic rate t_i^{a,k} (requests/s)."""
    return _traffic_scan(problem, state, _source_injection(problem), solver=solver)


def loads(problem: Problem, state: State, t: torch.Tensor | None = None):
    """Link load F [B, V, V] (Eq. 5) and node computation load G [B, V] (Eq. 6).

    Stages and partitions are accumulated sequentially, one fixed-shape
    contraction per step, so the real prefix's float associativity does not
    depend on the K envelope (appended phantom stages are exact-zero
    addends): what keeps stage padding bitwise-inert on J."""
    if t is None:
        t = stage_traffic(problem, state)
    apps = problem.apps
    n = state.phi.shape[-1]
    F = torch.zeros(t.shape[:-3] + (n, n), dtype=t.dtype, device=t.device)
    for k in range(state.phi.shape[-3]):
        f_k = t[..., k, :, None] * state.phi[..., k, :, :]  # [B, A, V, V] (Eq. 4)
        F = F + torch.einsum("ba,baij->bij", apps.L[..., k], f_k)
    G = torch.zeros(t.shape[:-3] + (n,), dtype=t.dtype, device=t.device)
    for p in range(apps.w.shape[-1]):
        G = G + torch.einsum("ba,bav->bv", apps.w[..., p], state.x[..., p, :] * t[..., p, :])
    return F, G


def objective_from_loads(problem: Problem, F: torch.Tensor, G: torch.Tensor):
    """[B] J and its comm/comp split from already-computed loads (Eq. 7)."""
    net, cm = problem.net, problem.cost
    D = costs.link_cost(F, net.mu, cm) * net.adj
    C = costs.comp_cost(G, net.nu, cm)
    j_comm = D.sum(dim=(-2, -1))
    j_comp = C.sum(dim=-1)
    J = bview(cm.w_comm, 1) * j_comm + bview(cm.w_comp, 1) * j_comp
    return J, j_comm, j_comp


def objective(problem: Problem, state: State, *, solver: str = "neumann"):
    """[B] J(x, phi) plus a breakdown dict (Eq. 7 / the Fig-5 weighted variant)."""
    t = stage_traffic(problem, state, solver=solver)
    F, G = loads(problem, state, t)
    J, j_comm, j_comp = objective_from_loads(problem, F, G)
    return J, {"J": J, "J_comm": j_comm, "J_comp": j_comp, "F": F, "G": G, "t": t}


def marginal_link_weights(problem: Problem, F: torch.Tensor) -> torch.Tensor:
    """w_comm * D'_ij(F_ij) on edges, BIG elsewhere [B, V, V]."""
    net, cm = problem.net, problem.cost
    dp = bview(cm.w_comm, F.ndim) * costs.link_cost_prime(F, net.mu, cm)
    return torch.where(net.adj > 0, dp, BIG)


def marginal_comp(problem: Problem, G: torch.Tensor) -> torch.Tensor:
    """kappa^{a,p}_i = w^{a,p} * w_comp * C'_i(G_i)   [B, A, P, V] (Eq. 12)."""
    cm = problem.cost
    cp = bview(cm.w_comp, G.ndim) * costs.comp_cost_prime(G, problem.net.nu, cm)  # [B, V]
    return problem.apps.w[..., None] * cp[..., None, None, :]


def objective_with_injection(
    problem: Problem,
    state: State,
    a: int,
    k: int,
    inj: torch.Tensor,
    *,
    solver: str = "neumann",
):
    """[B] J when an extra exogenous stage-k source `inj` [B, V] is added for
    app a. Gallager's identity: grad_inj J |_{inj=0} = q^{a,k}; the gradient
    runs through the Neumann solve's transpose-solve backward."""
    inject = _source_injection(problem)
    inject[..., a, k, :] = inject[..., a, k, :] + inj  # differentiable in inj
    t = _traffic_scan(problem, state, inject, solver=solver)
    F, G = loads(problem, state, t)
    J, _, _ = objective_from_loads(problem, F, G)
    return J


def total_absorbed(problem: Problem, state: State, *, solver: str = "neumann") -> torch.Tensor:
    """[B, A] final-stage traffic absorbed at each destination (equals
    lambda_a when forwarding is consistent)."""
    t = stage_traffic(problem, state, solver=solver)
    apps = problem.apps
    dst_oh = one_hot(apps.dst, problem.net.n_nodes)
    idx = apps.parts[..., None, None].expand(t.shape[:-2] + (1, t.shape[-1]))
    t_fin = torch.take_along_dim(t, idx, dim=-2)[..., 0, :]
    return (t_fin * dst_oh).sum(dim=-1)
