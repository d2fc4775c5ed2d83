"""The port's forwarding sweep on the CPU: `kernels.forwarding.ops.update_phi`
runs the plain tail for CPU tensors, and `core.forwarding_sweep` gives
bitwise the whole-tensor sweep written out below (link marginals, gap,
rate, blocking, decay, prune, one-hot reassignment), on single networks and
on padded fleets under both costs."""
import dataclasses

import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro_torch import core as T
from repro_torch.core import scenarios
from repro_torch.core.structs import BIG, BIG_THRESHOLD, CostModel, forwarding_mass, one_hot
from repro_torch.fleet import sample_fleet, stack_problems
from repro_torch.kernels import _build
from repro_torch.kernels.forwarding import ops, ref


def whole_tensor_sweep(problem, state, alpha):
    """The sweep as whole tensors of phi's size, written out in full."""
    n = problem.net.n_nodes
    q, dp, *_ = T.cost_to_go(problem, state)
    delta = problem.apps.L[..., None, None] * dp[:, None, None] + q[..., None, :]
    delta = torch.where(problem.net.adj[:, None, None] > 0, delta, BIG)
    mass = forwarding_mass(state, problem.apps, n)
    delta_min = delta.amin(dim=-1, keepdim=True)
    jstar_oh = one_hot(delta.argmin(dim=-1), n)
    gap = torch.where(delta < BIG_THRESHOLD, delta - delta_min, 0.0)
    rate = alpha * (gap / (delta_min.abs() + gap + 1e-12))
    improper = ~(q[..., None, :] < q[..., :, None])
    rate = torch.where(improper, alpha, rate)
    phi = state.phi * (1.0 - rate)
    phi = torch.where(phi < 1e-9, 0.0, phi)
    phi = phi * (1.0 - jstar_oh)
    others = phi.sum(dim=-1)
    return phi + jstar_oh * torch.clamp_min(mass - others, 0.0)[..., None]


def _problem(name):
    if name == "random_connected":
        return T.stack_single(scenarios.random_connected(40, 12, seed=3, device="cpu"))
    kind = name.split("_")[-1]
    problems = sample_fleet(6, seed=4, n_range=(12, 30), apps_range=(3, 8), partitions=(1, 2, 3), device="cpu")
    return stack_problems([dataclasses.replace(p, cost=CostModel(kind=kind)) for p in problems])[0]


@pytest.mark.parametrize("name", ["random_connected", "fleet_mm1", "fleet_linear"])
def test_forwarding_sweep_is_the_whole_tensor_sweep_bitwise(name, monkeypatch):
    """Four sweeps from the structured init, each bitwise the written-out
    sweep, through the CPU dispatch (no launch counted)."""
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    problem = _problem(name)
    state = T.structured_init(problem)
    for alpha in (0.5, 0.5, 0.7, 0.3):
        want = whole_tensor_sweep(problem, state, alpha)
        state = T.forwarding_sweep(problem, state, alpha=alpha)
        assert state.phi.dtype == torch.float32 and torch.equal(state.phi, want)
    assert not any(_build.LAUNCHES.values())


def test_update_phi_runs_the_plain_tail_on_cpu():
    """The dispatcher's CPU path is `ref.update_phi_ref`, and the link
    marginals it builds are `link_marginals`'."""
    problem = _problem("fleet_mm1")
    state = T.forwarding_update(problem, T.structured_init(problem), t_phi=2)
    q, dp, *_ = T.cost_to_go(problem, state)
    mass = forwarding_mass(state, problem.apps, problem.net.n_nodes)
    args = (state.phi, q, dp, problem.apps.L, problem.net.adj, mass, 0.5)
    assert torch.equal(ops.update_phi(*args), ref.update_phi_ref(*args))
    delta, _ = T.link_marginals(problem, state)
    assert torch.equal(ref.link_delta(q, dp, problem.apps.L, problem.net.adj), delta)
