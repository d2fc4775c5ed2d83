"""Algorithm 1 (ALT) and the paper's three baselines (section IV).

  ALT         alternating congestion-aware placement + forwarding (ours)
  OneShot     same init/objective, a single placement/forwarding round
  CongUnaware shortest extended path under linear (congestion-blind) costs
  CoLocated   all partitions forced to one node, forwarding optimized

All four share the structured initialization, so comparisons isolate one
design axis each. The iterative methods run the round engine at B=1 on the
device the caller names (default "cuda"), which must be where the
problem's tensors live. `solver` selects the fixed-point
path: "neumann" (default, the CUDA kernel on the card) or "lu" (dense
reference).
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import solve_device
from .engine import engine_solve_single, stack_single
from .flow import objective
from .placement import structured_init
from .structs import CostModel, Problem, State


@dataclasses.dataclass
class Result:
    name: str
    state: State
    J: float
    J_comm: float
    J_comp: float
    history: list
    iters: int

    def summary(self) -> str:
        return (
            f"{self.name:12s} J={self.J:10.4f}  comm={self.J_comm:10.4f} "
            f"comp={self.J_comp:10.4f}  iters={self.iters}"
        )


def _engine_result(problem: Problem, name: str, **engine_kw) -> Result:
    """Run the round engine at B=1 and package a sequential Result."""
    out = engine_solve_single(problem, **engine_kw)
    history = out["history"].cpu()
    history = history[~torch.isnan(history)]
    return Result(
        name=name,
        state=out["state"],
        J=float(out["J"]),
        J_comm=float(out["J_comm"]),
        J_comp=float(out["J_comp"]),
        history=[float(h) for h in history],
        iters=int(out["iters"]),
    )


def solve_alt(
    problem: Problem,
    *,
    m_max: int = 30,
    t_phi: int = 10,
    alpha: float = 0.5,
    tol: float = 1e-3,
    patience: int = 4,
    colocate: bool = False,
    solver: str = "neumann",
    name: str = "ALT",
    device: str | torch.device = "cuda",
) -> Result:
    """The full alternating method (Algorithm 1), with best-iterate tracking;
    stops when the best J has not improved by `tol` for `patience` rounds."""
    return _engine_result(
        problem, name, m_max=m_max, t_phi=t_phi, alpha=alpha, tol=tol,
        patience=patience, colocate=colocate, track_best=True, solver=solver, device=device,
    )


def solve_oneshot(
    problem: Problem,
    *,
    t_phi: int = 10,
    alpha: float = 0.5,
    solver: str = "neumann",
    device: str | torch.device = "cuda",
) -> Result:
    """One placement/forwarding round (the engine at m_max=1, returning the
    final iterate): isolates the value of alternation."""
    return _engine_result(
        problem, "OneShot", m_max=1, t_phi=t_phi, alpha=alpha, tol=1e-3,
        patience=1, colocate=False, track_best=False, solver=solver, device=device,
    )


def linearize(problem: Problem) -> Problem:
    """The same problem under congestion-blind linear costs (D=F/mu, C=G/nu)."""
    return Problem(
        net=problem.net,
        apps=problem.apps,
        cost=CostModel(
            kind="linear",
            rho_max=problem.cost.rho_max,
            w_comm=problem.cost.w_comm,
            w_comp=problem.cost.w_comp,
        ),
        hop_bound=problem.hop_bound,
    )


@torch.no_grad()
def solve_congunaware(
    problem: Problem, *, solver: str = "neumann", device: str | torch.device = "cuda"
) -> Result:
    """Shortest extended path under linear costs, evaluated with true costs.

    With linear costs the zero-load marginals ARE the link weights, so the
    extended-graph shortest path reduces to the structured initialization's
    stage DP under the linear cost model."""
    solve_device(problem.device, device)
    stacked = stack_single(problem)
    state = structured_init(stack_single(linearize(problem)))
    J, aux = objective(stacked, state, solver=solver)
    return Result(
        name="CongUnaware",
        state=State(x=state.x[0], phi=state.phi[0]),
        J=float(aux["J"][0]),
        J_comm=float(aux["J_comm"][0]),
        J_comp=float(aux["J_comp"][0]),
        history=[],
        iters=0,
    )


def solve_colocated(
    problem: Problem,
    *,
    m_max: int = 30,
    t_phi: int = 10,
    alpha: float = 0.5,
    tol: float = 1e-3,
    patience: int = 4,
    solver: str = "neumann",
    device: str | torch.device = "cuda",
) -> Result:
    """All partitions at a single node; forwarding still congestion-aware."""
    return solve_alt(
        problem, m_max=m_max, t_phi=t_phi, alpha=alpha, tol=tol, patience=patience,
        colocate=True, solver=solver, name="CoLocated", device=device,
    )


ALL_METHODS = {
    "ALT": solve_alt,
    "OneShot": solve_oneshot,
    "CongUnaware": solve_congunaware,
    "CoLocated": solve_colocated,
}

# The one source of truth for which solver kwargs each method accepts.
METHOD_KWARGS = {
    "ALT": ("m_max", "t_phi", "alpha", "tol", "patience", "solver"),
    "OneShot": ("t_phi", "alpha", "solver"),
    "CongUnaware": ("solver",),
    "CoLocated": ("m_max", "t_phi", "alpha", "tol", "patience", "solver"),
}


def validate_solver_kwargs(kw: dict) -> None:
    """Reject kwargs no method accepts: a typo must raise, never silently
    run with defaults."""
    unknown = set(kw) - set().union(*METHOD_KWARGS.values())
    if unknown:
        raise TypeError(f"unknown solver kwargs {sorted(unknown)}")


def method_kwargs(method: str, kw: dict) -> dict:
    """Restrict one shared (validated) kwargs dict to what `method` accepts."""
    validate_solver_kwargs(kw)
    return {k: v for k, v in kw.items() if k in METHOD_KWARGS[method]}


def compare_all(problem: Problem, *, device: str | torch.device = "cuda", **kw) -> dict:
    """Run all four methods on one shared kwargs dict (unknown kwargs raise)
    on `device`, which must be where the problem's tensors live."""
    return {
        name: fn(problem, device=device, **method_kwargs(name, kw))
        for name, fn in ALL_METHODS.items()
    }
