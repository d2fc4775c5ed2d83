"""Fleet-level failure repair: one batched `repair_placement` per epoch (the
JAX package's `chaos/repair.py`, on PyTorch).

The perturbed problems are padded and stacked exactly as `solve_fleet`
stacks them, the per-instance live masks are extended with zeros over the
pad tail (padded nodes ARE dead nodes under the shared encoding), and
`repair_placement`, batched over the instance axis, runs once. The result
is a stacked `State` ready for `solve_fleet(warm_start=...)`. With every
mask all-ones the returned State is bitwise the input.

`Apsp0Cache` keeps the zero-load APSP behind that repair across control
epochs: `zero_load_dp` reads only (adj, mu, cost), and most epochs perturb
none of them (flash crowds scale lam; event-free epochs change nothing),
so the previous epoch's [B, V, V] (dist, nexthop) pair is reused when
those inputs are equal by value. The key and the pair stay on the device:
the key is compared with `torch.equal`, and a hit hands `repair_placement`
the very tensors the miss computed. `launch.control --verify-apsp0` holds
every hit bitwise to a from-scratch solve.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.placement import repair_placement, zero_load_dp
from ..core.structs import State
from ..device import solve_device
from ..fleet.pad import stack_problems
from ..kernels.minplus import apsp_with_nexthop


@dataclasses.dataclass
class Apsp0Cache:
    """One fleet's zero-load APSP, on the device.

    key     : (cost kind, adj, mu, rho_max, w_comm, w_comp) of the stacked
              fleet the pair was computed from: everything `zero_load_dp`
              reads, compared by value each refresh
    dist    : [B, V, V] fp32 zero-load all-pairs distances
    nexthop : [B, V, V] int64 shortest-path next hops
    reused  : whether the last refresh was a hit (feeds `control.apsp0.*`)
    hits / misses : lifetime refresh counters
    """

    key: tuple
    dist: torch.Tensor
    nexthop: torch.Tensor
    reused: bool = False
    hits: int = 0
    misses: int = 0

    def sp(self):
        """The `(dist, nexthop)` pair in `repair_placement(sp=...)` form."""
        return self.dist, self.nexthop


def _apsp0_key(stacked) -> tuple:
    """Value key over everything `zero_load_dp` reads (kind is a string)."""
    c = stacked.cost
    return (c.kind, stacked.net.adj, stacked.net.mu, c.rho_max, c.w_comm, c.w_comp)


def _apsp0_key_equal(a: tuple, b: tuple) -> bool:
    if len(a) != len(b) or a[0] != b[0]:
        return False
    return all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(a[1:], b[1:])
    )


def _check_device(problems, device):
    return solve_device(problems[0].device, device) if problems else torch.device(device)


def refresh_apsp0(
    problems,
    cache: Apsp0Cache | None,
    *,
    round_to: int = 1,
    envelope=None,
    hop_bound=None,
    n_parts=None,
    device: str | torch.device = "cuda",
) -> Apsp0Cache:
    """Return a cache valid for this epoch's problems (hit or recompute).

    The envelope arguments must match what `repair_fleet` / `solve_fleet`
    use, so the [B, V, V] shapes line up. On a hit the returned cache is the
    old one with `reused=True`; on a miss the APSP is recomputed from
    scratch, `apsp_with_nexthop(zero_load_dp(stacked))`: the computation
    the sp=None path of `repair_placement` runs, on the same stacked inputs,
    which is what makes reuse bitwise-exact."""
    _check_device(problems, device)
    stacked, _ = stack_problems(
        problems, round_to=round_to, envelope=envelope, hop_bound=hop_bound, n_parts=n_parts,
    )
    key = _apsp0_key(stacked)
    if cache is not None and _apsp0_key_equal(cache.key, key):
        cache.reused = True
        cache.hits += 1
        return cache
    dist, nexthop = apsp_with_nexthop(zero_load_dp(stacked))
    return Apsp0Cache(
        key=key,
        dist=dist,
        nexthop=nexthop,
        reused=False,
        hits=cache.hits if cache is not None else 0,
        misses=(cache.misses if cache is not None else 0) + 1,
    )


def repair_fleet(
    problems,
    state: State,
    live_masks,
    *,
    round_to: int = 1,
    envelope=None,
    hop_bound=None,
    n_parts=None,
    apsp0: Apsp0Cache | None = None,
    device: str | torch.device = "cuda",
) -> State:
    """Evict every dead-hosted partition across a fleet in one batched call.

    problems   : the PERTURBED problems (dead nodes already pad-encoded)
    state      : stacked [B, ...] State over the fleet envelope, typically
                 `FleetResult.state` of the previous epoch's
                 `solve_fleet(..., keep_state=True)`
    live_masks : per-instance [V_i] masks from `chaos.apply_health`
                 (1.0 = live); shorter than the envelope is fine, the pad
                 tail is dead by definition
    round_to / envelope / hop_bound / n_parts : must match what the solves
                 use, so the stacked envelope (and the state's shape)
                 agrees epoch over epoch
    apsp0      : a `refresh_apsp0` cache covering THIS epoch's problems;
                 its (dist, nexthop) pair goes to `repair_placement(sp=...)`
                 (bitwise the sp=None path). None computes the APSP inside.
    """
    dev = _check_device(problems, device)
    stacked, _ = stack_problems(
        problems, round_to=round_to, envelope=envelope, hop_bound=hop_bound, n_parts=n_parts,
    )
    b = len(problems)
    v_env = int(stacked.net.adj.shape[-1])
    exp = (b,) + tuple(stacked.apps.w.shape[1:]) + (v_env,)
    if tuple(state.x.shape) != exp:
        raise ValueError(
            f"repair_fleet: state placement shape {tuple(state.x.shape)} "
            f"does not match the fleet envelope {exp} — the envelope "
            "drifted since the state was produced; re-solve cold"
        )
    masks = np.zeros((b, v_env), np.float32)
    for i, m in enumerate(live_masks):
        m = np.asarray(m, dtype=np.float32)
        masks[i, : m.size] = m
    return repair_placement(
        stacked, state, torch.tensor(masks, device=dev), sp=None if apsp0 is None else apsp0.sp()
    )
