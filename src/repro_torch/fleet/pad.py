"""Stacking same-shape problems into one `[B, ...]` batch for the engine.

Only instances that already share (V, A, P) are stacked here; padding of
heterogeneous fleets to a common envelope is not ported yet.
"""
from __future__ import annotations

import torch

from ..core.structs import Apps, CostModel, Network, Problem


def unify_hop_bound(problems) -> int:
    """One batch-wide Neumann hop bound: the max over instances, with the
    nilpotency-index bound V + 1 standing in for any instance without one.
    Extra hops past an instance's own bound are no-ops under the early exit."""
    return max(
        p.hop_bound if p.hop_bound is not None else p.net.n_nodes + 1
        for p in problems
    )


def stack_problems(problems) -> Problem:
    """Stack same-shape problems along a new leading instance axis.

    Cost scalars become [B] float32 tensors (they may differ per instance;
    `kind` may not); `hop_bound` is unified to the batch max. Raises
    ValueError on an empty batch, mixed cost kinds or ragged shapes."""
    problems = list(problems)
    if not problems:
        raise ValueError("stack_problems: empty batch")
    kinds = {p.cost.kind for p in problems}
    if len(kinds) > 1:
        raise ValueError(f"batch mixes cost kinds {sorted(kinds)}")
    shapes = {(p.net.n_nodes, p.apps.n_apps, p.apps.n_parts) for p in problems}
    if len(shapes) > 1:
        raise ValueError(
            f"stack_problems needs one (V, A, P) shape, got {sorted(shapes)}; "
            "padding heterogeneous instances is not ported yet"
        )
    dev = problems[0].device

    def stack(get):
        return torch.stack([get(p) for p in problems])

    def scalars(name):
        return torch.tensor(
            [float(getattr(p.cost, name)) for p in problems], dtype=torch.float32, device=dev
        )

    return Problem(
        net=Network(**{k: stack(lambda p, k=k: getattr(p.net, k)) for k in ("adj", "mu", "nu")}),
        apps=Apps(**{
            k: stack(lambda p, k=k: getattr(p.apps, k))
            for k in ("src", "dst", "lam", "L", "w", "parts")
        }),
        cost=CostModel(
            kind=kinds.pop(),
            rho_max=scalars("rho_max"),
            w_comm=scalars("w_comm"),
            w_comp=scalars("w_comp"),
        ),
        hop_bound=unify_hop_bound(problems),
    )
