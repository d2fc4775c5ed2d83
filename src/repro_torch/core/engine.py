"""The ALT round engine: one loop behind the sequential solvers (core/alt.py)
and batched solves over same-shape instances (fleet/pad.stack_problems).

Algorithm 1 is a single alternating loop (placement sweep -> T_phi
forwarding sweeps -> objective). `round_step` is one round over the whole
batch: placement is fed the previous round's `round_eval`, then T_phi
forwarding sweeps, then one `round_eval` closes the round; the best
iterate, the stall/patience counters and the per-lane freeze masks are
updated on the device. `engine_solve` loops rounds while any lane is live
and `m < m_max`, reading one `any(active)` scalar per round (the loop's
only host sync outside the placement sweep's min-plus closure). With a
process `group` (the fleet mesh of fleet/solve.py, each rank holding its
own lanes) that flag is one `all_reduce(MAX)` over the group a round, JAX's
one collective a trip: every rank runs the same rounds, so `m`, the
history and the trace have one length on every rank. Frozen lanes are masked out of every carry update, so
extra rounds driven by live lanes leave them bit-identical, and the
`[B, m_max + 1]` history is NaN past each lane's freeze point.

The optional round trace (`EngineTrace`, DESIGN.md section 14) is written
by the same masked column updates as the history, from values the round
already produced: the solve's outputs are bitwise the same with or without
it, and it adds no host sync. `lane_chunk=k` runs the same engine on
consecutive k-lane slices instead of the fused batch, with the same
per-lane results.

While `obs.trace` is on, each trip of the round loop is one
`solve_fleet.round` span (`round_step` and the exit-flag read that ends
the trip, with the round's host syncs), holding one span a phase:
`solve_fleet.round.placement`, `.forwarding` and `.eval`. The sequential
solvers reach this engine at B=1, so their rounds carry the same names.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..device import solve_device
from ..obs.sync import read_flag, sync_span
from ..obs.trace import span
from .forwarding import forwarding_update
from .marginals import round_eval
from .placement import placement_update, structured_init
from .structs import CostModel, Problem, State, app_live_mask, partition_live_mask


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
class EngineTrace:
    """Round-trace buffers. Every `[B, m_max + 1]` buffer follows the history
    contract: column m is written by round m and keeps its init value (NaN,
    or 0.0 for `live`) wherever the round was not applied to the lane.

    J_comm / J_comp : objective split per applied round (column 0: init)
    moves           : placement churn, live (app, partition) hosts that
                      changed in the round; column 0 is 0.0
    live            : 1.0 iff the round was applied to the lane
    best_round      : [B] int32 round index of the running best iterate
    """

    J_comm: torch.Tensor
    J_comp: torch.Tensor
    moves: torch.Tensor
    live: torch.Tensor
    best_round: torch.Tensor


def placement_churn(problem: Problem, new: State, old: State) -> torch.Tensor:
    """[B] count of live (app, partition) hosts that differ between two
    batched states; phantom apps and phantom partitions are masked out so
    padding cannot leak churn."""
    live = partition_live_mask(problem.apps) * app_live_mask(problem.apps)[..., None]
    return ((new.hosts() != old.hosts()) * live).sum(dim=(-2, -1))


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
    trace              : `EngineTrace`, or None when tracing is off
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
    trace: EngineTrace | None = None


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
) -> EngineCarry:
    """One batched ALT round: Algorithm 1's loop body plus bookkeeping.

    Stall is measured against the best J before this round's update, and
    every carry slot of a frozen lane is masked back to its old value."""
    with span("solve_fleet.round.placement"):
        nxt = placement_update(problem, carry.state, carry.aux["ctg"], colocate=colocate, solver=solver)
    with span("solve_fleet.round.forwarding", t_phi=t_phi):
        nxt = forwarding_update(problem, nxt, t_phi=t_phi, alpha=alpha, solver=solver)
    with span("solve_fleet.round.eval"):
        J, aux_nxt = round_eval(problem, nxt, solver=solver)

    improved = J < carry.best_J * (1.0 - tol)
    stall_nxt = torch.where(improved, 0, carry.stall + 1)
    is_best = J < carry.best_J
    best_state_nxt = _bwhere(is_best, nxt, carry.best_state)
    best_obj_nxt = _bwhere(is_best, _objective_of(aux_nxt), carry.best_obj)
    best_J_nxt = torch.minimum(J, carry.best_J)

    active = carry.active
    col = carry.m + 1
    history = carry.history.clone()
    history[:, col] = torch.where(active, J, torch.nan)
    trace = carry.trace
    if trace is not None:
        # Inactive lanes store exactly the buffer's init value.
        moved = placement_churn(problem, nxt, carry.state)
        j_comm, j_comp, moves, live = (
            x.clone() for x in (trace.J_comm, trace.J_comp, trace.moves, trace.live)
        )
        j_comm[:, col] = torch.where(active, aux_nxt["J_comm"], torch.nan)
        j_comp[:, col] = torch.where(active, aux_nxt["J_comp"], torch.nan)
        moves[:, col] = torch.where(active, moved.to(moves.dtype), torch.nan)
        live[:, col] = active.to(live.dtype)
        trace = EngineTrace(
            J_comm=j_comm, J_comp=j_comp, moves=moves, live=live,
            best_round=torch.where(active & is_best, col, trace.best_round),
        )
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
        trace=trace,
    )


def _any_active(active: torch.Tensor, group) -> bool:
    """Whether any lane is live: on this rank alone, or over `group`."""
    if group is None:
        return read_flag(active.any(), "engine.exit_flag")
    flag = active.any().to(torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return read_flag(flag, "engine.exit_flag")


def _engine_solve_batch(stacked, *, m_max, t_phi, alpha, tol, patience, colocate, track_best,
                        solver, trace, keep_state, init_state, active0, group, dev) -> dict:
    """The fused-batch engine: init, then one lockstep round loop over every
    lane of `stacked` (see `engine_solve`)."""
    if init_state is None:
        state0 = structured_init(stacked, colocate=colocate)
    else:
        state0 = init_state
    J0, aux0 = round_eval(stacked, state0, solver=solver)
    batch = J0.shape[0]
    history = torch.full((batch, m_max + 1), torch.nan, dtype=J0.dtype, device=dev)
    history[:, 0] = J0
    trace0 = None
    if trace:
        def nan_buf(first):
            buf = torch.full((batch, m_max + 1), torch.nan, dtype=J0.dtype, device=dev)
            buf[:, 0] = first
            return buf

        live = torch.zeros((batch, m_max + 1), dtype=J0.dtype, device=dev)
        live[:, 0] = 1.0
        trace0 = EngineTrace(
            J_comm=nan_buf(aux0["J_comm"]), J_comp=nan_buf(aux0["J_comp"]), moves=nan_buf(0.0),
            live=live, best_round=torch.zeros(batch, dtype=torch.int32, device=dev),
        )
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
        trace=trace0,
    )
    # Each trip ends in the next trip's exit test, so that read (which
    # waits for the round's device work) lies inside the round's span.
    live = carry.m < m_max and _any_active(carry.active, group)
    while live:
        with sync_span("solve_fleet.round", m=carry.m + 1):
            carry = round_step(
                stacked, carry, t_phi=t_phi, alpha=alpha, tol=tol, patience=patience,
                colocate=colocate, solver=solver,
            )
            live = carry.m < m_max and _any_active(carry.active, group)
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
        "trace": carry.trace,
    }
    if keep_state:
        out["state"] = out_state
    return out


def _lanes(x, sl: slice):
    """Lanes `sl` of a stacked Problem / State / tensor (None passes)."""
    if x is None or isinstance(x, (int, float, str)):
        return x
    if isinstance(x, torch.Tensor):
        return x[sl]
    return type(x)(**{f.name: _lanes(getattr(x, f.name), sl) for f in dataclasses.fields(x)})


def _concat(outs: list):
    """Join per-slice engine outputs along the lane axis."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat(outs)
    return type(first)(**{
        f.name: _concat([getattr(o, f.name) for o in outs]) for f in dataclasses.fields(first)
    })


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
    trace: bool = False,
    lane_chunk: int | None = 0,
    keep_state: bool = True,
    init_state: State | None = None,
    active0: torch.Tensor | None = None,
    group=None,
    device: str | torch.device = "cuda",
) -> dict:
    """Run the alternating method on a stacked `[B, ...]` problem on
    `device`, which must be where the problem's tensors live (a CUDA request
    without a GPU raises; pass device="cpu" to solve on the CPU).

    `init_state` seeds the loop from a caller-provided `[B, ...]` State
    instead of `structured_init`; `active0` [B] bool freezes lanes from
    round 0 (a frozen-from-start lane returns its init evaluation).
    `trace=True` carries the round trace out as `out["trace"]`; every
    other output is bitwise the same either way. `lane_chunk` picks the
    layout over the instance axis: 0 or None = the fused batch, one round
    loop over all lanes; k >= 1 = the same engine on consecutive k-lane
    slices, each with its own early exit. Per-lane results are the same in
    both layouts (bitwise on the CPU; on the card the Neumann and min-plus
    kernels do not depend on the batch, PyTorch's reductions may).
    `group` (a `torch.distributed` process group, or None) makes the
    round loop's exit flag a reduction over every rank of the group, each
    solving its own lanes; every rank of the group must call this with the
    same m_max and lane_chunk. None changes nothing.

    Returns a dict (leading axis B throughout):
      J / J_comm / J_comp : final objective split (best iterate, or the
                            final state when `track_best=False`)
      state               : the returned State (absent if not keep_state)
      hosts               : [B, A, P] partition hosts of the returned state
      history             : [B, m_max + 1] objective trace, NaN past freeze
      iters               : [B] int32 rounds applied per instance
      rounds              : int, loop trips executed (the slowest slice's)
      trace               : `EngineTrace`, or None when `trace=False`
    """
    dev = solve_device(stacked.device, device)
    if lane_chunk is not None and lane_chunk < 0:
        raise ValueError(f"lane_chunk must be >= 0, got {lane_chunk}")
    kw = dict(
        m_max=m_max, t_phi=t_phi, alpha=alpha, tol=tol, patience=patience, colocate=colocate,
        track_best=track_best, solver=solver, trace=trace, keep_state=keep_state,
        group=group, dev=dev,
    )
    if not lane_chunk:
        return _engine_solve_batch(stacked, init_state=init_state, active0=active0, **kw)
    if active0 is not None:
        active0 = torch.as_tensor(active0, device=dev).reshape(-1).to(torch.bool)
    batch = stacked.net.adj.shape[0]
    outs = []
    for i in range(0, batch, lane_chunk):
        sl = slice(i, min(i + lane_chunk, batch))
        outs.append(_engine_solve_batch(
            _lanes(stacked, sl), init_state=_lanes(init_state, sl), active0=_lanes(active0, sl), **kw
        ))
    out = {k: _concat([o[k] for o in outs]) for k in outs[0] if k != "rounds"}
    out["rounds"] = max(o["rounds"] for o in outs)
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
    if isinstance(v, (State, EngineTrace)):
        return type(v)(**{f.name: getattr(v, f.name)[0] for f in dataclasses.fields(v)})
    return v


def engine_solve_single(problem: Problem, **kw) -> dict:
    """Sequential entry point: the engine at B=1, squeezed (`rounds` stays
    an int)."""
    out = engine_solve(stack_single(problem), **kw)
    return {k: _squeeze(v) if k != "rounds" else v for k, v in out.items()}
