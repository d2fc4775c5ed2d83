"""Marginal-cost placement reassignment (paper Eqs. 12-16), phi repair and
failure repair.

The stage-k edge weight L_{a,k} D'_{ij}(F_{ij}) differs across stages only
by the scalar L_{a,k}, so one APSP under the base weight D'_{ij}(F_{ij})
per instance serves every (application, stage). APSP and the next-hop table
are min-plus products (kernels/minplus; the CUDA kernel on the card).

Candidate score of partition p (upstream comm + local comp + downstream comm):

    S_{a,p}(i) = L_{a,p} dist[up_a, i] + kappa^{a,p}_i + L_{a,p+1} dist[i, down_a]

with `up_a` the NEW host of partition p-1 (s_a for p = 0) and `down_a` the
OLD host of partition p+1 (d_a for the last live partition); partitions
are updated in order (the paper's footnote 5).

The sweep is the paper's sequential Gauss-Seidel scan over applications
(kernels/placement), vectorised over the instance axis B: on the card one
kernel launch a sweep, one CTA walking a lane's apps and partitions; on the
CPU a Python loop over apps and partitions that evaluates the dense compute
marginal `cprime(G)` at every step. The two give the same hosts.

After placement changes, every (app, stage) whose target host moved gets
phi rebuilt as the shortest-path next-hop tree toward the new host under
the current congested marginals; other stages keep their multipath phi.
All functions take stacked [B, ...] problems and states.
"""
from __future__ import annotations

import torch

from . import costs
from ..kernels.minplus import apsp_with_nexthop
from ..kernels.placement import ops as sweep_ops
from .marginals import cost_to_go
from .structs import (
    BIG,
    Problem,
    State,
    app_live_mask,
    bview,
    one_hot,
    partition_live_mask,
    stage_live_mask,
    stage_targets,
)


def _sp_tree_phi(nexthop: torch.Tensor, target: torch.Tensor, mass: torch.Tensor, n: int):
    """phi rows = one-hot(next hop toward `target`), scaled by row mass.

    nexthop: [B, V, V] (column t = toward target t); target: [B, A, K];
    mass: [B, A, K, V]. Returns [B, A, K, V, V]."""
    b, a, k = target.shape
    cols = target.reshape(b, a * k, 1).expand(b, a * k, n)
    nh = torch.gather(nexthop.mT, 1, cols).reshape(b, a, k, n)  # nexthop[b, :, t]
    return one_hot(nh, n) * mass[..., None]


def zero_load_dp(problem: Problem) -> torch.Tensor:
    """[B, V, V] zero-load marginal link metric D'_{ij}(0), BIG off the
    adjacency: the seed weight behind `structured_init`."""
    cm = problem.cost
    mu = problem.net.mu
    dp0 = bview(cm.w_comm, mu.ndim) * costs.link_cost_prime(torch.zeros_like(mu), mu, cm)
    return torch.where(problem.net.adj > 0, dp0, BIG)


def comp_marginal(problem: Problem):
    """cprime(G) = w_comp * D'_comp(G): the dense compute marginal [B, V]
    that the sweep scores with."""
    cm, nu = problem.cost, problem.net.nu

    def cprime(Gv):
        return bview(cm.w_comp, Gv.ndim) * costs.comp_cost_prime(Gv, nu, cm)

    return cprime


def placement_update(
    problem: Problem,
    state: State,
    ctg=None,
    *,
    colocate: bool = False,
    move_margin: float = 0.02,
    solver: str = "neumann",
) -> State:
    """One placement reassignment sweep over all applications.

    `ctg` is an optional (q, dp, kappa, t, F, G) tuple from `cost_to_go` /
    `round_eval` evaluated at `state` (the engine passes the round-final
    evaluation). Link marginals stay fixed during the sweep."""
    n = problem.net.n_nodes
    if ctg is None:
        ctg = cost_to_go(problem, state, solver=solver)
    q, dp, kappa, t, F, G = ctg
    dist, nexthop = apsp_with_nexthop(dp)
    hosts_new = sweep_ops.placement_sweep(
        problem, state.hosts(), dist, G, comp_marginal(problem), colocate=colocate,
        move_margin=move_margin,
    )
    new_state = State(x=one_hot(hosts_new, n), phi=state.phi)
    return repair_phi(problem, state, new_state, nexthop)


def repair_phi(
    problem: Problem,
    old: State,
    new: State,
    nexthop: torch.Tensor,
    force: torch.Tensor | None = None,
) -> State:
    """Rebuild phi for stages whose absorption target moved (or `force`
    [B, A, K] asks for it) as shortest-path trees; phantom stages keep zero
    mass and zero-rate apps zero phi."""
    n = problem.net.n_nodes
    apps = problem.apps
    old_t = stage_targets(apps, old.hosts())  # [B, A, K]
    new_t = stage_targets(apps, new.hosts())
    m = (1.0 - one_hot(new_t, n)) * stage_live_mask(apps)[..., None]
    tree = _sp_tree_phi(nexthop, new_t, m, n)
    rebuild = old_t != new_t
    if force is not None:
        rebuild = rebuild | force
    phi = torch.where(rebuild[..., None, None], tree, new.phi)
    phi = phi * app_live_mask(apps)[..., None, None, None]
    return State(x=new.x, phi=phi)


def repair_placement(
    problem: Problem, state: State, node_mask: torch.Tensor, *, sp=None
) -> State:
    """Evict partitions from masked-out hosts to the best live node.

    The failure-repair primitive (DESIGN.md section 15): `node_mask` [B, V]
    (1.0 = live) over a problem whose dead nodes already carry the pad
    encoding (adj = 0, mu = BIG, nu = NU_PAD). Partitions hosted on dead
    nodes are rescored under the zero-load marginals (the metric of
    `structured_init`) and moved to the argmin live host, walking the chain
    in order so partition p sees the repaired host of p-1; partitions on
    live hosts stay. `sp` injects a precomputed `(dist, nexthop)` for
    `zero_load_dp(problem)`. phi is repaired by `repair_phi`, with a forced
    rebuild of every stage whose phi carries mass into a dead node.

    With node_mask all ones the state comes back bitwise."""
    n = problem.net.n_nodes
    apps = problem.apps
    n_parts = apps.n_parts
    if sp is None:
        dist, nexthop = apsp_with_nexthop(zero_load_dp(problem))
    else:
        dist, nexthop = sp
    cm, nu = problem.cost, problem.net.nu
    cp0 = bview(cm.w_comp, nu.ndim) * costs.comp_cost_prime(torch.zeros_like(nu), nu, cm)
    # Hard eviction barrier on top of the dead node's 1/NU_PAD marginal.
    node_pen = torch.where(node_mask > 0, 0.0, BIG)[:, None, :]  # [B, 1, V]

    hosts = state.hosts()  # [B, A, P]
    b, a = hosts.shape[:2]
    bidx = torch.arange(b, device=hosts.device)[:, None]
    p_idx = torch.arange(n_parts, device=hosts.device)
    live = p_idx < apps.parts[..., None]
    dead_host = node_mask.gather(1, hosts.reshape(b, a * n_parts)).reshape(hosts.shape) <= 0
    down = torch.where(
        p_idx + 1 < apps.parts[..., None],
        torch.cat([hosts[..., 1:], apps.dst[..., None]], dim=-1),
        apps.dst[..., None],
    )
    dist_t = dist.mT
    up = apps.src
    hs = []
    for p in range(n_parts):
        S = (
            apps.L[..., p, None] * dist[bidx, up]
            + apps.w[..., p, None] * cp0[:, None, :]
            + apps.L[..., p + 1, None] * dist_t[bidx, down[..., p]]
            + node_pen
        )
        h = torch.where(live[..., p] & dead_host[..., p], S.argmin(dim=-1), hosts[..., p])
        up = torch.where(live[..., p], h, up)
        hs.append(h)
    hosts_new = torch.stack(hs, dim=-1)

    dead = (node_mask <= 0).to(state.phi.dtype)  # [B, V]
    force = torch.einsum("bakuv,bv->bak", state.phi, dead) > 0
    new_state = State(x=one_hot(hosts_new, n), phi=state.phi)
    return repair_phi(problem, state, new_state, nexthop, force)


def structured_init(problem: Problem, *, colocate: bool = False) -> State:
    """Feasible structured initialization (paper section IV, method a).

    Zero-load marginal weights D'_{ij}(0) give the uncongested shortest-path
    metric; hosts come from an O(K V^2) Viterbi-style DP over the stage chain
    (cost-to-come per candidate host, first-minimum backpointers, final leg
    to the destination), and phi is initialized to the SP next-hop trees.
    The final tie-break key (last real backpointer * V + host) reproduces the
    row-major flat-argmin pair choice of the historical P = 2 scan."""
    n = problem.net.n_nodes
    apps = problem.apps
    n_parts = apps.n_parts
    dist, nexthop = apsp_with_nexthop(zero_load_dp(problem))
    cm, nu = problem.cost, problem.net.nu
    cp0 = bview(cm.w_comp, nu.ndim) * costs.comp_cost_prime(torch.zeros_like(nu), nu, cm)
    kappa0 = apps.w[..., None] * cp0[:, None, None, :]  # [B, A, P, V]

    L = apps.L
    bidx = torch.arange(dist.shape[0], device=dist.device)[:, None]
    dist_from_src = dist[bidx, apps.src, :]  # [B, A, V]
    dist_to_dst = dist[bidx, :, apps.dst]  # [B, A, V]: dist[b, i, dst_a]
    live = partition_live_mask(apps)  # [B, A, P]
    L_fin = torch.gather(L, -1, apps.parts[..., None])[..., 0]  # [B, A]
    idx_j = torch.arange(n, device=dist.device)

    if colocate:
        S = L[..., 0, None] * dist_from_src
        for p in range(n_parts):
            S = S + kappa0[..., p, :] * live[..., p, None]
        S = S + L_fin[..., None] * dist_to_dst
        hosts = S.argmin(dim=-1)[..., None].expand(apps.parts.shape + (n_parts,))
    else:
        # Forward DP: M_p(j) = cost-to-come of hosting partition p at j.
        M = L[..., 0, None] * dist_from_src + kappa0[..., 0, :]  # [B, A, V]
        ptrs = []
        for p in range(1, n_parts):
            cand = M[..., :, None] + L[..., p, None, None] * dist[:, None]  # [B, A, V, V]
            ptr = cand.argmin(dim=-2)
            M_new = cand.amin(dim=-2) + kappa0[..., p, :]
            live_p = live[..., p, None] > 0
            # Phantom transition: identity, keeping the real chain bitwise.
            M = torch.where(live_p, M_new, M)
            ptrs.append(torch.where(live_p, ptr, idx_j))
        total = M + L_fin[..., None] * dist_to_dst  # [B, A, V]

        # Among minimizing final hosts j prefer the smallest last REAL
        # backpointer, then the smallest j.
        m = total.amin(dim=-1, keepdim=True)
        if ptrs:
            ptrs_arr = torch.stack(ptrs, dim=-2)  # [B, A, P-1, V]
            t_idx = torch.clamp(apps.parts - 2, 0, n_parts - 2)
            ptr_last = torch.gather(
                ptrs_arr, -2, t_idx[..., None, None].expand(t_idx.shape + (1, n))
            )[..., 0, :]
            ptr_last = torch.where(apps.parts[..., None] >= 2, ptr_last, idx_j)
        else:
            ptr_last = idx_j.expand(total.shape)
        key = torch.where(total == m, ptr_last * n + idx_j, n * n)
        hs = [None] * n_parts
        hs[n_parts - 1] = key.argmin(dim=-1)
        for p in range(n_parts - 1, 0, -1):
            hs[p - 1] = torch.gather(ptrs[p - 1], -1, hs[p][..., None])[..., 0]
        hosts = torch.stack(hs, dim=-1)  # [B, A, P]

    targets = stage_targets(apps, hosts)  # [B, A, K]
    m = (1.0 - one_hot(targets, n)) * stage_live_mask(apps)[..., None]
    phi = _sp_tree_phi(nexthop, targets, m, n) * app_live_mask(apps)[..., None, None, None]
    return State(x=one_hot(hosts, n), phi=phi)
