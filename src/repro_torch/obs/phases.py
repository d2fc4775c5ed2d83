"""Per-phase round profile: where one ALT round spends its time (the JAX
package's `obs/phases.py`).

The engine's round body runs placement sweep -> T_phi forwarding sweeps ->
round_eval in one call, so host spans around `solve_fleet` cannot say which
phase dominates. This module runs the three phases on their own over the
same stacked fleet and warm state, timing each (best of `reps`, after one
warm call) under the obs host spans

    round.phases   round.placement   round.forwarding   round.round_eval

so the numbers land in any configured trace (REPRO_TRACE) next to the
solve-level spans. On the card each call is timed with CUDA events around
it; on the CPU with `time.perf_counter`.

As in the reference, the phases timed apart bound the fused round from
above: treat the split as a dominance profile, not an exact decomposition.
"""
from __future__ import annotations

import time

import torch

from ..device import solve_device
from .trace import span

PHASES = ("placement", "forwarding", "round_eval")


def _best_of(fn, reps: int, cuda: bool) -> float:
    """Seconds of the fastest of `reps` calls of `fn`."""
    best = float("inf")
    for _ in range(reps):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def profile_round_phases(
    problems,
    *,
    t_phi: int,
    alpha: float = 0.5,
    colocate: bool = False,
    solver: str = "neumann",
    block_apps: int = 1,
    round_to: int = 1,
    reps: int = 3,
    device="cuda",
) -> dict:
    """Time each round phase over a stacked fleet at a warm round-1 state.

    The state driven through the phases is the one round 1 of the engine
    would see (structured init + one evaluation), so the profile reflects
    the real in-loop tensor shapes and placement churn. The problems must
    live on `device`. Returns per-phase warm best-of-`reps` milliseconds
    plus the share of their sum:

        {"batch", "t_phi", "block_apps",
         "placement_ms", "forwarding_ms", "round_eval_ms",
         "placement_share", "forwarding_share", "round_eval_share"}
    """
    # Imported here, not at module top: obs is a leaf package the solver
    # layers import freely.
    from ..core.forwarding import forwarding_update
    from ..core.marginals import round_eval
    from ..core.placement import placement_update, structured_init
    from ..fleet.pad import stack_problems

    problems = list(problems)
    stacked, _ = stack_problems(problems, round_to=round_to)
    cuda = solve_device(stacked.device, device).type == "cuda"

    def place():
        return placement_update(stacked, state, ctg, colocate=colocate, solver=solver,
                                block_apps=block_apps)

    def fwd():
        return forwarding_update(stacked, placed, t_phi=t_phi, alpha=alpha, solver=solver)

    def ev():
        return round_eval(stacked, forwarded, solver=solver)

    times = {}
    with torch.no_grad():
        state = structured_init(stacked, colocate=colocate)
        ctg = round_eval(stacked, state, solver=solver)[1]["ctg"]
        placed = place()  # the warm calls
        forwarded = fwd()
        ev()
        with span("round.phases", batch=len(problems), block_apps=block_apps):
            with span("round.placement", block_apps=block_apps):
                times["placement"] = _best_of(place, reps, cuda)
            with span("round.forwarding", t_phi=t_phi):
                times["forwarding"] = _best_of(fwd, reps, cuda)
            with span("round.round_eval"):
                times["round_eval"] = _best_of(ev, reps, cuda)

    total = sum(times.values())
    out = {"batch": len(problems), "t_phi": t_phi, "block_apps": block_apps}
    for k in PHASES:
        out[f"{k}_ms"] = round(times[k] * 1e3, 3)
        out[f"{k}_share"] = round(times[k] / total, 4)
    return out
