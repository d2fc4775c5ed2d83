"""The plain sequential placement sweep: the CPU path of
`ops.placement_sweep` and the oracle its kernel is held to, bitwise, on the
card (tests/test_torch_placement_sweep_card.py).

A Python loop over apps and partitions, vectorised over the instance axis
B, that evaluates the dense compute marginal `cprime(G)` at every step:
about 30 small torch operations a step.
"""
from __future__ import annotations

import torch

from ...core.structs import one_hot


def sequential_sweep(problem, hosts, dist, G, cprime, *, colocate, move_margin):
    """The paper's sequential Gauss-Seidel app scan, batched over B.

    Each app removes its own loads from the incrementally maintained G (so
    kappa is the marginal of adding it), walks its partition chain in
    footnote-5 order, and commits its chosen hosts' loads before the next
    app is scored. Load updates are dense one-hot adds, bit-for-bit the
    JAX scan's: g - load * one_hot is g - load at the host and g elsewhere."""
    n = problem.net.n_nodes
    apps = problem.apps
    n_apps, n_parts = hosts.shape[-2:]
    bidx = torch.arange(hosts.shape[0], device=hosts.device)
    p_idx = torch.arange(n_parts, device=hosts.device)
    margin = 1.0 - move_margin

    def pick(S, h_prev):
        # Hysteresis: only move when the improvement beats move_margin.
        cand = S.argmin(dim=-1)
        better = S[bidx, cand] < margin * S[bidx, h_prev]
        return torch.where(better, cand, h_prev)

    Gv = G
    h_out = []
    for a in range(n_apps):
        src_a, dst_a, h_old = apps.src[:, a], apps.dst[:, a], hosts[:, a]
        L_a, w_a, parts_a = apps.L[:, a], apps.w[:, a], apps.parts[:, a]
        loads_a = w_a * apps.lam[:, a, None]  # [B, P]
        live = p_idx < parts_a[:, None]  # [B, P]
        for p in range(n_parts):
            Gv = Gv - loads_a[:, p, None] * one_hot(h_old[:, p], n)

        if colocate:
            w_tot = torch.where(live, w_a, 0.0).sum(dim=-1)
            load_tot = torch.where(live, loads_a, 0.0).sum(dim=-1)
            L_fin = torch.gather(L_a, 1, parts_a[:, None])[:, 0]
            S = (
                L_a[:, 0, None] * dist[bidx, src_a, :]
                + w_tot[:, None] * cprime(Gv)
                + L_fin[:, None] * dist[bidx, :, dst_a]
            )
            h = pick(S, h_old[:, 0])
            h_out.append(torch.where(live, h[:, None], h_old))
            Gv = Gv + load_tot[:, None] * one_hot(h, n)
            continue

        # Old downstream anchor of partition p: partition p+1's current
        # host, or the destination for the last live partition (and phantoms).
        down = torch.where(
            p_idx + 1 < parts_a[:, None],
            torch.cat([h_old[:, 1:], dst_a[:, None]], dim=1),
            dst_a[:, None],
        )
        up = src_a
        hs = []
        for p in range(n_parts):
            S = (
                L_a[:, p, None] * dist[bidx, up, :]
                + w_a[:, p, None] * cprime(Gv)
                + L_a[:, p + 1, None] * dist[bidx, :, down[:, p]]
            )
            h = torch.where(live[:, p], pick(S, h_old[:, p]), h_old[:, p])
            Gv = Gv + torch.where(live[:, p], loads_a[:, p], 0.0)[:, None] * one_hot(h, n)
            hs.append(h)
            up = h
        h_out.append(torch.stack(hs, dim=-1))
    return torch.stack(h_out, dim=1)  # [B, A, P]
