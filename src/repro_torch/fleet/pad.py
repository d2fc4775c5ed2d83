"""Mask-aware padding of heterogeneous problems to a common (V, A, P)
envelope, and stacking into one `[B, ...]` batch for the engine (the JAX
package's `fleet/pad.py`, on PyTorch).

Padded coordinates are inert (DESIGN.md sections 9 and 13):

  padded nodes   adj = 0, mu = BIG, nu = NU_PAD: zero incident traffic
                 gives exactly zero D and C, while the marginal compute cost
                 1/NU_PAD and the BIG link distances keep every init and
                 placement sweep off them.
  padded apps    lambda = 0, L = 0, w = 0, src = dst = 0, parts = 1: zero
                 traffic, zero load in the placement sweep, zero J.
  padded stages  phantom partitions carry L = 0 / w = 0 trailing entries and
                 `Apps.parts` keeps each app's real depth; every stage-generic
                 step gates on `parts`, so a stage-padded instance runs
                 bitwise like its unpadded original.

Pads are built on the device the problems live on.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.structs import BIG, Apps, CostModel, Network, Problem
from ..obs.sync import count_syncs
from ..obs.trace import span

# Compute rate of a padded (or dead) node: the marginal compute cost
# C'(0) = 1/NU_PAD dominates any congested real marginal, while C(0) = 0
# keeps its contribution to J exactly zero.
NU_PAD = 1e-9


class EmptyFleetError(ValueError):
    """A fleet operation was handed zero solvable instances: none at all, or
    every node of every instance dead (nu <= NU_PAD)."""


@dataclasses.dataclass(frozen=True)
class PadInfo:
    """Validity masks for one padded instance (or a stacked fleet of them).

    node_mask : [..., V] float32, 1.0 on real nodes, 0.0 on padding
    app_mask  : [..., A] float32, 1.0 on real apps, 0.0 on padding
    """

    node_mask: torch.Tensor
    app_mask: torch.Tensor

    @property
    def n_real_nodes(self) -> int:
        return int(self.node_mask.sum())

    @property
    def n_real_apps(self) -> int:
        return int(self.app_mask.sum())


def pad_network(net: Network, n_nodes: int) -> Network:
    """Pad a Network to `n_nodes` with disconnected, compute-dead nodes."""
    v = net.n_nodes
    if n_nodes < v:
        raise ValueError(f"cannot pad {v} nodes down to {n_nodes}")
    if n_nodes == v:
        return net
    pad = n_nodes - v
    return Network(
        adj=F.pad(net.adj, (0, pad, 0, pad)),
        mu=F.pad(net.mu, (0, pad, 0, pad), value=BIG),
        nu=F.pad(net.nu, (0, pad), value=NU_PAD),
    )


def pad_apps(apps: Apps, n_apps: int, n_parts: int | None = None) -> Apps:
    """Pad an Apps set to `n_apps` with zero-rate, zero-size phantom apps,
    and (optionally) the partition axis to `n_parts` with phantom stages.
    Phantom apps get parts = 1: any valid depth, lambda = 0 makes them inert."""
    a, p_old = apps.n_apps, apps.n_parts
    p_new = p_old if n_parts is None else n_parts
    if n_apps < a:
        raise ValueError(f"cannot pad {a} apps down to {n_apps}")
    if p_new < p_old:
        raise ValueError(f"cannot pad {p_old} partitions down to {p_new}")
    if n_apps == a and p_new == p_old:
        return apps
    pad, ppad = n_apps - a, p_new - p_old
    return Apps(
        src=F.pad(apps.src, (0, pad)),
        dst=F.pad(apps.dst, (0, pad)),
        lam=F.pad(apps.lam, (0, pad)),
        L=F.pad(apps.L, (0, ppad, 0, pad)),
        w=F.pad(apps.w, (0, ppad, 0, pad)),
        parts=F.pad(apps.parts, (0, pad), value=1),
    )


def pad_problem(
    problem: Problem, n_nodes: int, n_apps: int, n_parts: int | None = None
) -> tuple[Problem, PadInfo]:
    """Pad one problem to the (n_nodes, n_apps[, n_parts]) envelope; returns
    the masks too. Padded nodes are disconnected and phantom stages carry no
    traffic, so the carried `hop_bound` is unchanged."""
    v, a = problem.net.n_nodes, problem.apps.n_apps
    dev = problem.device
    padded = Problem(
        net=pad_network(problem.net, n_nodes),
        apps=pad_apps(problem.apps, n_apps, n_parts),
        cost=problem.cost,
        hop_bound=problem.hop_bound,
    )
    info = PadInfo(
        node_mask=(torch.arange(n_nodes, device=dev) < v).to(torch.float32),
        app_mask=(torch.arange(n_apps, device=dev) < a).to(torch.float32),
    )
    return padded, info


def pad_problem_parts(problem: Problem, n_parts: int) -> Problem:
    """Pad ONLY the partition axis to `n_parts` (phantom stages): bitwise
    invisible to the solver on the real stages."""
    return dataclasses.replace(problem, apps=pad_apps(problem.apps, problem.apps.n_apps, n_parts))


def fleet_envelope(problems, round_to: int = 1) -> tuple[int, int]:
    """Common (V, A) envelope of a fleet, rounded up to a multiple of
    `round_to` so a long-running control plane sees few distinct shapes."""

    def up(x: int) -> int:
        return ((x + round_to - 1) // round_to) * round_to

    return up(max(p.net.n_nodes for p in problems)), up(max(p.apps.n_apps for p in problems))


def fleet_part_envelope(problems) -> int:
    """Common partition-axis envelope: the max structural P over the fleet
    (never rounded: each extra stage costs an [A, V, V] phi slab)."""
    return max(p.apps.n_parts for p in problems)


def unify_hop_bound(problems) -> int:
    """One batch-wide Neumann hop bound: the max over instances, with the
    nilpotency-index bound V + 1 standing in for any instance without one.
    Extra hops past an instance's own bound are no-ops under the early exit."""
    return max(
        p.hop_bound if p.hop_bound is not None else p.net.n_nodes + 1
        for p in problems
    )


def _check_nonempty(problems, who: str) -> None:
    if not problems:
        raise EmptyFleetError(f"{who}: empty fleet")
    if all(float(p.net.nu.max()) <= NU_PAD for p in problems):
        raise EmptyFleetError(
            f"{who}: every node of every instance is dead (nu <= NU_PAD = {NU_PAD:g}); "
            "an all-dead fleet has no live host set to solve over"
        )


def pad_batch_to_multiple(problems, multiple: int) -> tuple[list, int]:
    """Extend a batch with inert repeats of its first instance up to the next
    multiple of `multiple`; returns (extended_problems, n_real). Repeats are
    inert: every engine lane runs the same per-instance computation, and the
    caller trims everything past n_real."""
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1, got {multiple}")
    problems = list(problems)
    _check_nonempty(problems, "pad_batch_to_multiple")
    n = len(problems)
    target = -(-n // multiple) * multiple
    return problems + [problems[0]] * (target - n), n


def stack_problems(
    problems, round_to: int = 1, envelope: tuple[int, int] | None = None,
    hop_bound: int | None = None, n_parts: int | None = None,
) -> tuple[Problem, PadInfo]:
    """Pad every instance to the fleet envelope and stack along a new
    leading instance axis; returns (stacked_problem, stacked_info).

    Cost scalars become [B] float32 tensors (they may differ per instance;
    `kind` may not). `envelope` / `hop_bound` / `n_parts` override the
    computed (V, A) envelope, the unified hop bound and the partition
    envelope: the chunked fleet path passes the global values so every
    chunk runs at one shape. While tracing, the per-lane padding is one
    `solve_fleet.pad` span whose `lanes_padded` counts the lanes whose
    (V, A, P) differ from the envelope."""
    problems = list(problems)
    if not problems:
        raise EmptyFleetError("stack_problems: empty fleet")
    kinds = {p.cost.kind for p in problems}
    if len(kinds) > 1:
        raise ValueError(
            f"fleet mixes cost kinds {sorted(kinds)}; CostModel.kind selects a code path "
            "and must be uniform within one batch"
        )
    v, a = envelope if envelope is not None else fleet_envelope(problems, round_to=round_to)
    p_env = n_parts if n_parts is not None else fleet_part_envelope(problems)
    hb = hop_bound if hop_bound is not None else unify_hop_bound(problems)
    with span("solve_fleet.pad") as rec:
        padded, infos = zip(*(pad_problem(p, v, a, p_env) for p in problems))
        if rec is not None:
            rec["lanes_padded"] = sum(
                (p.net.n_nodes, p.apps.n_apps, p.apps.n_parts) != (v, a, p_env) for p in problems
            )
    dev = problems[0].device

    def stack(group, names):
        return {k: torch.stack([getattr(getattr(p, group), k) for p in padded]) for k in names}

    def scalars(name):
        # A blocking copy from the host: on the card the host waits for it.
        count_syncs(1)
        return torch.tensor(
            [float(getattr(p.cost, name)) for p in problems], dtype=torch.float32, device=dev
        )

    stacked = Problem(
        net=Network(**stack("net", ("adj", "mu", "nu"))),
        apps=Apps(**stack("apps", ("src", "dst", "lam", "L", "w", "parts"))),
        cost=CostModel(kind=kinds.pop(), rho_max=scalars("rho_max"), w_comm=scalars("w_comm"),
                       w_comp=scalars("w_comp")),
        hop_bound=hb,
    )
    info = PadInfo(
        node_mask=torch.stack([i.node_mask for i in infos]),
        app_mask=torch.stack([i.app_mask for i in infos]),
    )
    return stacked, info
