"""The ALT round engine: one loop behind the sequential solvers (core/alt.py)
and batched solves over same-shape instances (fleet/pad.stack_problems).

Algorithm 1 is a single alternating loop (placement sweep -> T_phi
forwarding sweeps -> objective). `round_step` is one round over the whole
batch: placement is fed the previous round's `round_eval`, then T_phi
forwarding sweeps, then one `round_eval` closes the round; the best
iterate, the stall/patience counters and the per-lane freeze masks are
updated on the device. `engine_solve` loops rounds while any lane is live
and `m < m_max`, reading one `any(active)` scalar per round (the only host
sync of the loop). Frozen lanes are masked out of every carry update, so
extra rounds driven by live lanes leave them bit-identical, and the
`[B, m_max + 1]` history is NaN past each lane's freeze point.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import solve_device
from .forwarding import forwarding_update
from .marginals import round_eval
from .placement import placement_update, structured_init
from .structs import CostModel, Problem, State


def _bwhere(pred: torch.Tensor, a, b):
    """Select a or b per lane with a [B] predicate, through State / dict /
    tuple containers."""
    if isinstance(a, torch.Tensor):
        return torch.where(pred.reshape(pred.shape + (1,) * (a.ndim - 1)), a, b)
    if isinstance(a, State):
        return State(x=_bwhere(pred, a.x, b.x), phi=_bwhere(pred, a.phi, b.phi))
    if isinstance(a, dict):
        return {k: _bwhere(pred, a[k], b[k]) for k in a}
    return tuple(_bwhere(pred, x, y) for x, y in zip(a, b))


def _objective_of(aux):
    """The objective split alone (the best-iterate slot never carries the
    ctg tensors)."""
    return {"J": aux["J"], "J_comm": aux["J_comm"], "J_comp": aux["J_comp"]}


@dataclasses.dataclass(frozen=True)
class EngineCarry:
    """Everything one ALT round reads and writes.

    state / best_state : [B, ...] current and best iterate
    aux                : `round_eval` output at `state` (objective split +
                         the ctg tuple the next placement sweep consumes)
    best_obj           : {"J", "J_comm", "J_comp"} at `best_state`
    best_J             : [B] running minimum objective
    stall              : [B] rounds since the last tol-sized improvement
    iters              : [B] rounds actually applied per instance
    active             : [B] bool; False once an instance froze
    m                  : rounds the loop ran
    history            : [B, m_max + 1] objective trace, NaN past freeze
    """

    state: State
    aux: dict
    best_state: State
    best_obj: dict
    best_J: torch.Tensor
    stall: torch.Tensor
    iters: torch.Tensor
    active: torch.Tensor
    m: int
    history: torch.Tensor


def round_step(
    problem: Problem,
    carry: EngineCarry,
    *,
    t_phi: int,
    alpha: float,
    tol: float,
    patience: int,
    colocate: bool,
    solver: str,
    block_apps: int = 1,
) -> EngineCarry:
    """One batched ALT round: Algorithm 1's loop body plus bookkeeping.

    Stall is measured against the best J before this round's update, and
    every carry slot of a frozen lane is masked back to its old value."""
    nxt = placement_update(
        problem, carry.state, carry.aux["ctg"], colocate=colocate, solver=solver,
        block_apps=block_apps,
    )
    nxt = forwarding_update(problem, nxt, t_phi=t_phi, alpha=alpha, solver=solver)
    J, aux_nxt = round_eval(problem, nxt, solver=solver)

    improved = J < carry.best_J * (1.0 - tol)
    stall_nxt = torch.where(improved, 0, carry.stall + 1)
    is_best = J < carry.best_J
    best_state_nxt = _bwhere(is_best, nxt, carry.best_state)
    best_obj_nxt = _bwhere(is_best, _objective_of(aux_nxt), carry.best_obj)
    best_J_nxt = torch.minimum(J, carry.best_J)

    active = carry.active
    history = carry.history.clone()
    history[:, carry.m + 1] = torch.where(active, J, torch.nan)
    return EngineCarry(
        state=_bwhere(active, nxt, carry.state),
        aux=_bwhere(active, aux_nxt, carry.aux),
        best_state=_bwhere(active, best_state_nxt, carry.best_state),
        best_obj=_bwhere(active, best_obj_nxt, carry.best_obj),
        best_J=torch.where(active, best_J_nxt, carry.best_J),
        stall=torch.where(active, stall_nxt, carry.stall),
        iters=carry.iters + active.to(torch.int32),
        active=active & (stall_nxt < patience),
        m=carry.m + 1,
        history=history,
    )


@torch.no_grad()
def engine_solve(
    stacked: Problem,
    *,
    m_max: int,
    t_phi: int,
    alpha: float,
    tol: float,
    patience: int,
    colocate: bool = False,
    track_best: bool = True,
    solver: str = "neumann",
    block_apps: int = 1,
    keep_state: bool = True,
    init_state: State | None = None,
    active0: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Run the alternating method on a stacked `[B, ...]` problem on
    `device`, which must be where the problem's tensors live (a CUDA request
    without a GPU raises; pass device="cpu" to solve on the CPU).

    `init_state` seeds the loop from a caller-provided `[B, ...]` State
    instead of `structured_init`; `active0` [B] bool freezes lanes from
    round 0 (a frozen-from-start lane returns its init evaluation).

    Returns a dict (leading axis B throughout):
      J / J_comm / J_comp : final objective split (best iterate, or the
                            final state when `track_best=False`)
      state               : the returned State (absent if not keep_state)
      hosts               : [B, A, P] partition hosts of the returned state
      history             : [B, m_max + 1] objective trace, NaN past freeze
      iters               : [B] int32 rounds applied per instance
      rounds              : int, loop trips actually executed
      trace               : None (the round trace is not ported yet)
    """
    dev = solve_device(stacked.device, device)
    if init_state is None:
        state0 = structured_init(stacked, colocate=colocate)
    else:
        state0 = init_state
    J0, aux0 = round_eval(stacked, state0, solver=solver)
    batch = J0.shape[0]
    history = torch.full((batch, m_max + 1), torch.nan, dtype=J0.dtype, device=dev)
    history[:, 0] = J0
    if active0 is None:
        active = torch.ones(batch, dtype=torch.bool, device=dev)
    else:
        active = torch.as_tensor(active0, device=dev).reshape(batch).to(torch.bool)
    carry = EngineCarry(
        state=state0,
        aux=aux0,
        best_state=state0,
        best_obj=_objective_of(aux0),
        best_J=J0,
        stall=torch.zeros(batch, dtype=torch.int32, device=dev),
        iters=torch.zeros(batch, dtype=torch.int32, device=dev),
        active=active,
        m=0,
        history=history,
    )
    while carry.m < m_max and bool(carry.active.any()):
        carry = round_step(
            stacked, carry, t_phi=t_phi, alpha=alpha, tol=tol, patience=patience,
            colocate=colocate, solver=solver, block_apps=block_apps,
        )
    if track_best:
        out_state, out_obj = carry.best_state, carry.best_obj
    else:
        out_state, out_obj = carry.state, _objective_of(carry.aux)
    out = {
        "J": out_obj["J"],
        "J_comm": out_obj["J_comm"],
        "J_comp": out_obj["J_comp"],
        "hosts": out_state.hosts(),
        "history": carry.history,
        "iters": carry.iters,
        "rounds": carry.m,
        "trace": None,
    }
    if keep_state:
        out["state"] = out_state
    return out


def stack_single(problem: Problem) -> Problem:
    """Lift one problem to a `[1, ...]` stacked problem (engine batch of
    one). Cost scalars become [1] float32 tensors, as `stack_problems`
    makes them; `hop_bound` and `kind` pass through."""
    dev = problem.device

    def lift(x):
        return x[None] if isinstance(x, torch.Tensor) else torch.tensor(
            [x], dtype=torch.float32, device=dev
        )

    net, apps, cm = problem.net, problem.apps, problem.cost
    return Problem(
        net=type(net)(**{f.name: lift(getattr(net, f.name)) for f in dataclasses.fields(net)}),
        apps=type(apps)(**{f.name: lift(getattr(apps, f.name)) for f in dataclasses.fields(apps)}),
        cost=CostModel(
            kind=cm.kind, rho_max=lift(cm.rho_max), w_comm=lift(cm.w_comm), w_comp=lift(cm.w_comp)
        ),
        hop_bound=problem.hop_bound,
    )


def _squeeze(v):
    if isinstance(v, torch.Tensor):
        return v[0]
    if isinstance(v, State):
        return State(x=v.x[0], phi=v.phi[0])
    return v


def engine_solve_single(problem: Problem, **kw) -> dict:
    """Sequential entry point: the engine at B=1, squeezed (`rounds` stays
    an int; `trace` None)."""
    out = engine_solve(stack_single(problem), **kw)
    return {k: _squeeze(v) if k != "rounds" else v for k, v in out.items()}
