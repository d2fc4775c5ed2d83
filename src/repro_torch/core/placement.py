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

Sweep schedules (`block_apps`, DESIGN.md section 18), both vectorised over
the instance axis B:

  * `block_apps=1`: the paper's sequential Gauss-Seidel scan over
    applications (kernels/placement): on the card one kernel launch a
    sweep, one CTA walking a lane's apps and partitions; on the CPU a
    Python loop over apps and partitions that evaluates the dense compute
    marginal `cprime(G)` at every step. The two give the same hosts.
  * `block_apps=k>1` (0 = all apps in one block): the blocked sweep. Per
    block the downstream score legs of all k apps and one dense
    `cprime(G)` base are computed at once; the decisions stay a serial
    walk in app order, with the compute marginal corrected only on the
    <= 2P node slots an app's own removals and choices touch, and every
    commit's delta folded into the carried marginal at the slots it
    touched. Every decision sees the bits the sequential scan would, so
    the result is bitwise invariant to the block size. The walk reads no
    value back to the host.

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
    that both sweeps score with."""
    cm, nu = problem.cost, problem.net.nu

    def cprime(Gv):
        return bview(cm.w_comp, Gv.ndim) * costs.comp_cost_prime(Gv, nu, cm)

    return cprime


def _blocked_sweep(problem, hosts, dist, G, cprime, cprime_at, *, colocate, move_margin, bk, with_cert):
    """Blocked placement sweep: batched per-block precompute around an exact
    serial decision core (module doc).

    Per block of `bk` apps (the last block may be shorter):

      1. PRECOMPUTE, batched over [B, bk, ...]: the downstream legs
         `L_dn * dist[:, down]` (old-host anchored, as in the sequential
         scan) and one dense `cprime(G)` base at the block-entry G.
      2. DECIDE + COMMIT, serial in app order: partition p's row is
         assembled in the sequential scan's operation order,
         `(L_up * dist[up, :] + w_p * cprime) + downstream`, with the compute
         marginal recomputed only on the tracked slots `I` (the P old hosts,
         then one slot per chain step retargeted to the chosen host), whose
         values `gval` replay the scan's own-load operations, and scattered
         into the carried marginal before the row is formed. Each commit
         applies removals then additions in partition order and refreshes
         the carried marginal `cpw` at the slots it touched. Slots that hold
         the same node hold the same value, so scattering them is
         order-safe.

    Returns (hosts_new [B, A, P], cert), cert None unless `with_cert`: the
    decision certificates (old and final hosts, the moved mask, the scores
    S_new / S_old of each decision in its context, one column per app under
    `colocate`, and the block-entry G [B, n_blocks, V])."""
    apps = problem.apps
    n_apps, n_parts = hosts.shape[-2:]
    dev = hosts.device
    bidx = torch.arange(hosts.shape[0], device=dev)
    p_idx = torch.arange(n_parts, device=dev)
    # Column P + p of the tracked slots: chain step p's chosen host.
    step_col = [torch.full((hosts.shape[0], 1), n_parts + p, device=dev) for p in range(n_parts)]
    margin = 1.0 - move_margin

    live_all = p_idx < apps.parts[..., None]  # [B, A, P]
    rem_all = apps.w * apps.lam[..., None]  # own loads, phantom ones exact zeros
    add_all = torch.where(live_all, rem_all, 0.0)
    down_all = torch.where(
        p_idx + 1 < apps.parts[..., None],
        torch.cat([hosts[..., 1:], apps.dst[..., None]], dim=-1),
        apps.dst[..., None],
    )
    dist_t = dist.mT  # dist_t[b, t] = dist[b, :, t]

    def pick(S, h_prev):
        cand = S.argmin(dim=-1)
        better = S[bidx, cand] < margin * S[bidx, h_prev]
        return torch.where(better, cand, h_prev)

    Gc = G
    h_out, s_new, s_old, g_entry = [], [], [], []
    for j0 in range(0, n_apps, bk):
        j1 = min(j0 + bk, n_apps)
        g_entry.append(Gc)
        cpw = cprime(Gc)  # the block's dense base
        if colocate:
            DN = (torch.gather(apps.L[:, j0:j1], 2, apps.parts[:, j0:j1, None])
                  * dist_t[bidx[:, None], apps.dst[:, j0:j1]])  # [B, bk, V]
        else:
            DN = apps.L[:, j0:j1, 1:, None] * dist_t[bidx[:, None, None], down_all[:, j0:j1]]  # [B, bk, P, V]
        for a in range(j0, j1):
            h_old = hosts[:, a]  # [B, P]
            rem, add, live = rem_all[:, a], add_all[:, a], live_all[:, a]
            src, L_a, w_a = apps.src[:, a], apps.L[:, a], apps.w[:, a]
            if colocate:
                I = h_old
                gval = Gc.gather(1, I)
                for p2 in range(n_parts):
                    gval = gval - torch.where(I == h_old[:, p2, None], rem[:, p2, None], 0.0)
                w_tot = torch.where(live, w_a, 0.0).sum(dim=-1)
                load_tot = torch.where(live, rem, 0.0).sum(dim=-1)
                cp = cpw.scatter(1, I, cprime_at(gval, I))
                S = L_a[:, 0, None] * dist[bidx, src] + w_tot[:, None] * cp + DN[:, a - j0]
                h = pick(S, h_old[:, 0])
                for p2 in range(n_parts):
                    Gc = Gc.scatter_add(1, h_old[:, p2, None], -rem[:, p2, None])
                Gc = Gc.scatter_add(1, h[:, None], load_tot[:, None])
                I = torch.cat([h_old, h[:, None]], dim=1)
                cpw = cpw.scatter(1, I, cprime_at(Gc.gather(1, I), I))
                h_out.append(torch.where(live, h[:, None], h_old))
                if with_cert:
                    s_new.append(S[bidx, h][:, None])
                    s_old.append(S[bidx, h_old[:, 0]][:, None])
                continue

            I = torch.cat([h_old, h_old], dim=1)  # [B, 2P] tracked slots
            gval = Gc.gather(1, I)
            for p2 in range(n_parts):
                gval = gval - torch.where(I == h_old[:, p2, None], rem[:, p2, None], 0.0)
            up = src
            hs, sn, so = [], [], []
            for p in range(n_parts):
                cp = cpw.scatter(1, I, cprime_at(gval, I))
                S = L_a[:, p, None] * dist[bidx, up] + w_a[:, p, None] * cp + DN[:, a - j0, p]
                h = torch.where(live[:, p], pick(S, h_old[:, p]), h_old[:, p])
                # Retarget this step's slot to the chosen host: a tracked
                # node carries its tracked value (equal in every slot that
                # holds it), any other node the carried G.
                match = I == h[:, None]
                tracked = torch.where(match, gval, -torch.inf).amax(dim=-1)
                val_h = torch.where(match.any(dim=-1), tracked, Gc[bidx, h])
                I = I.scatter(1, step_col[p], h[:, None])
                gval = gval.scatter(1, step_col[p], val_h[:, None])
                gval = gval + torch.where(I == h[:, None], add[:, p, None], 0.0)
                hs.append(h)
                if with_cert:
                    sn.append(torch.where(live[:, p], S[bidx, h], S[bidx, h_old[:, p]]))
                    so.append(S[bidx, h_old[:, p]])
                up = h
            h_fin = torch.stack(hs, dim=1)
            # Commit in the scan's order (removals, then additions), then
            # refresh the carried marginal at exactly the tracked slots.
            for p2 in range(n_parts):
                Gc = Gc.scatter_add(1, h_old[:, p2, None], -rem[:, p2, None])
            for p2 in range(n_parts):
                Gc = Gc.scatter_add(1, h_fin[:, p2, None], add[:, p2, None])
            cpw = cpw.scatter(1, I, cprime_at(Gc.gather(1, I), I))
            h_out.append(h_fin)
            if with_cert:
                s_new.append(torch.stack(sn, dim=1))
                s_old.append(torch.stack(so, dim=1))
    hosts_new = torch.stack(h_out, dim=1)  # [B, A, P]
    if not with_cert:
        return hosts_new, None
    cert = {
        "h_old": hosts,
        "h_fin": hosts_new,
        "moved": hosts_new != hosts,
        "S_new": torch.stack(s_new, dim=1),
        "S_old": torch.stack(s_old, dim=1),
        "G_entry": torch.stack(g_entry, dim=1),
        "block": bk,
    }
    return hosts_new, cert


def _placement_update_impl(problem, state, ctg, *, colocate, move_margin, solver, block_apps,
                           force_blocked, with_cert=False):
    if block_apps < 0:
        raise ValueError(f"block_apps must be >= 0 (0 = all apps per block), got {block_apps}")
    n = problem.net.n_nodes
    if ctg is None:
        ctg = cost_to_go(problem, state, solver=solver)
    q, dp, kappa, t, F, G = ctg
    dist, nexthop = apsp_with_nexthop(dp)
    cm, nu = problem.cost, problem.net.nu
    cprime = comp_marginal(problem)

    def cprime_at(g, idx):
        # The same elementwise marginal at gathered node slots: gathering nu
        # keeps each slot bitwise equal to the dense vector's entry.
        return bview(cm.w_comp, g.ndim) * costs.comp_cost_prime(g, nu.gather(-1, idx), cm)

    hosts = state.hosts()
    a_tot = problem.apps.n_apps
    bk = a_tot if (block_apps == 0 or block_apps >= a_tot) else block_apps
    cert = None
    if bk <= 1 and not force_blocked:
        hosts_new = sweep_ops.placement_sweep(
            problem, hosts, dist, G, cprime, colocate=colocate, move_margin=move_margin
        )
    else:
        hosts_new, cert = _blocked_sweep(
            problem, hosts, dist, G, cprime, cprime_at, colocate=colocate,
            move_margin=move_margin, bk=max(bk, 1), with_cert=with_cert,
        )
    new_state = State(x=one_hot(hosts_new, n), phi=state.phi)
    return repair_phi(problem, state, new_state, nexthop), cert


def placement_update(
    problem: Problem,
    state: State,
    ctg=None,
    *,
    colocate: bool = False,
    move_margin: float = 0.02,
    solver: str = "neumann",
    block_apps: int = 1,
) -> State:
    """One placement reassignment sweep over all applications.

    `ctg` is an optional (q, dp, kappa, t, F, G) tuple from `cost_to_go` /
    `round_eval` evaluated at `state` (the engine passes the round-final
    evaluation). Link marginals stay fixed during the sweep. `block_apps`
    selects the schedule (module doc): 1 = the sequential scan, k > 1 = the
    blocked sweep in blocks of k apps, 0 = one block over every app; the
    result is bitwise the same for every value. Negative values raise
    ValueError."""
    new_state, _ = _placement_update_impl(
        problem, state, ctg, colocate=colocate, move_margin=move_margin, solver=solver,
        block_apps=block_apps, force_blocked=False,
    )
    return new_state


def blocked_placement_update(
    problem: Problem,
    state: State,
    ctg=None,
    *,
    colocate: bool = False,
    move_margin: float = 0.02,
    solver: str = "neumann",
    block_apps: int = 1,
) -> State:
    """`placement_update` forced through the blocked sweep at any block size,
    1 included: the test entry behind the claim that the blocked algorithm,
    not a dispatch branch, reproduces the sequential scan bitwise."""
    new_state, _ = _placement_update_impl(
        problem, state, ctg, colocate=colocate, move_margin=move_margin, solver=solver,
        block_apps=block_apps, force_blocked=True,
    )
    return new_state


def blocked_sweep_cert(
    problem: Problem,
    state: State,
    ctg=None,
    *,
    colocate: bool = False,
    move_margin: float = 0.02,
    solver: str = "neumann",
    block_apps: int = 1,
) -> dict:
    """The decision certificates of one blocked sweep (see `_blocked_sweep`):
    every committed move carries S_new < (1 - move_margin) * S_old in its
    decision context."""
    _, cert = _placement_update_impl(
        problem, state, ctg, colocate=colocate, move_margin=move_margin, solver=solver,
        block_apps=block_apps, force_blocked=True, with_cert=True,
    )
    return cert


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
