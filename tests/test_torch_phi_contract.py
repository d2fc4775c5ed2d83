"""The cost-to-go's two contractions of phi on the CPU:
`kernels.phi_contract.ops` runs the plain versions for CPU tensors, and
`loads`' F, `cost_to_go`'s link term and the whole cost-to-go stay bitwise
the stage-by-stage expressions written out below, on a single network and
on padded fleets under both costs. The autograd Functions the CUDA path
takes are checked here in float64 with the plain versions standing in for
the launches: each backward is the other contraction (they are adjoints)
plus an outer product in phi."""
import dataclasses

import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro_torch import core as T
from repro_torch.core import scenarios
from repro_torch.core.flow import marginal_comp, marginal_link_weights, stage_solve
from repro_torch.core.structs import CostModel, partition_live_mask
from repro_torch.fleet import sample_fleet, stack_problems
from repro_torch.kernels import _build
from repro_torch.kernels.phi_contract import ops, ref

NAMES = ["random_connected", "fleet_mm1", "fleet_linear"]


def _problem(name):
    if name == "random_connected":
        return T.stack_single(scenarios.random_connected(40, 12, seed=3, device="cpu"))
    kind = name.split("_")[-1]
    problems = sample_fleet(6, seed=4, n_range=(12, 30), apps_range=(3, 8), partitions=(1, 2, 3), device="cpu")
    return stack_problems([dataclasses.replace(p, cost=CostModel(kind=kind)) for p in problems])[0]


def _refined(name):
    problem = _problem(name)
    state = T.forwarding_update(problem, T.structured_init(problem), t_phi=3)
    return problem, state, T.stage_traffic(problem, state)


def written_out_F(problem, state, t):
    """`loads`' F as the stage loop of [B, A, V, V] products and einsums."""
    n = state.phi.shape[-1]
    F = torch.zeros(t.shape[:-3] + (n, n), dtype=t.dtype)
    for k in range(state.phi.shape[-3]):
        f_k = t[..., k, :, None] * state.phi[..., k, :, :]
        F = F + torch.einsum("ba,baij->bij", problem.apps.L[..., k], f_k)
    return F


def written_out_link_term(phi, dp_edges, L, k):
    return L[..., k, None] * (phi[..., k, :, :] * dp_edges[:, None]).sum(dim=-1)


def written_out_cost_to_go(problem, state, t):
    """The cost-to-go with the link term formed inside the reversed stage
    loop, one stage at a time."""
    F, G = T.loads(problem, state, t)
    dp = marginal_link_weights(problem, F)
    dp_edges = torch.where(problem.net.adj > 0, dp, 0.0)
    kappa = marginal_comp(problem, G)
    L = problem.apps.L
    live = partition_live_mask(problem.apps)[..., None]
    zeros_tail = torch.zeros_like(state.x[..., :1, :])
    gates = torch.cat([state.x * live, zeros_tail], dim=-2)
    kappas = torch.cat([kappa * live, zeros_tail], dim=-2)
    q_next = torch.zeros_like(gates[..., 0, :])
    qs = [None] * state.phi.shape[-3]
    for k in reversed(range(state.phi.shape[-3])):
        c = written_out_link_term(state.phi, dp_edges, L, k) + gates[..., k, :] * (kappas[..., k, :] + q_next)
        q_next = stage_solve(state.phi[..., k, :, :], c, problem, transpose=False)
        qs[k] = q_next
    return torch.stack(qs, dim=-2)


@pytest.mark.parametrize("name", NAMES)
def test_phi_loads_on_cpu_is_the_stage_loop_bitwise(name, monkeypatch):
    """`ops.phi_loads` and `loads`' F are the written-out stage loop's F
    bitwise, through the CPU dispatch (no launch counted)."""
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    problem, state, t = _refined(name)
    want = written_out_F(problem, state, t)
    assert torch.equal(ops.phi_loads(state.phi, t, problem.apps.L), want)
    assert torch.equal(T.loads(problem, state, t)[0], want)
    assert float(want.abs().sum()) > 0
    assert not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("name", NAMES)
def test_phi_link_term_on_cpu_is_the_stage_expression_bitwise(name, monkeypatch):
    """Every stage of `ops.phi_link_term` is the link term `cost_to_go`
    formed stage by stage, bitwise, through the CPU dispatch."""
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    problem, state, t = _refined(name)
    F = T.loads(problem, state, t)[0]
    dp_edges = torch.where(problem.net.adj > 0, marginal_link_weights(problem, F), 0.0)
    got = ops.phi_link_term(state.phi, dp_edges, problem.apps.L)
    assert got.shape == t.shape
    for k in range(state.phi.shape[-3]):
        assert torch.equal(got[..., k, :], written_out_link_term(state.phi, dp_edges, problem.apps.L, k))
    assert float(got.abs().sum()) > 0
    assert not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("name", NAMES)
def test_cost_to_go_on_cpu_is_unchanged_bitwise(name):
    """q of `cost_to_go` (link terms of every stage formed before the
    reversed loop) is the stage-by-stage cost-to-go's, bitwise."""
    problem, state, t = _refined(name)
    q = T.cost_to_go(problem, state, t)[0]
    assert torch.equal(q, written_out_cost_to_go(problem, state, t))


def _plain_launches(monkeypatch):
    """The autograd Functions with the plain versions standing in for the
    launches, so their backward runs here."""
    monkeypatch.setattr(ops, "_launch_loads", ref.phi_loads_ref)
    monkeypatch.setattr(ops, "_launch_link_term", ref.phi_link_term_ref)


def _operands(seed, b=2, a=3, k=2, v=5):
    g = torch.Generator().manual_seed(seed)
    phi = torch.rand(b, a, k, v, v, generator=g, dtype=torch.float64)
    t = torch.rand(b, a, k, v, generator=g, dtype=torch.float64)
    dp = torch.rand(b, v, v, generator=g, dtype=torch.float64)
    L = 0.5 + torch.rand(b, a, k, generator=g, dtype=torch.float64)
    return phi, t, dp, L


@pytest.mark.parametrize("fn", ["phi_loads", "phi_link_term"])
def test_autograd_functions_pass_gradcheck(fn, monkeypatch):
    """Each Function's backward (the other contraction for the vector and
    L, an outer product for phi) against finite differences, first and
    second order."""
    _plain_launches(monkeypatch)
    phi, t, dp, L = (x.requires_grad_(True) for x in _operands(1))
    if fn == "phi_loads":
        args, apply = (phi, t, L), ops._PhiLoads.apply
    else:
        args, apply = (phi, dp, L), ops._PhiLinkTerm.apply
    assert torch.autograd.gradcheck(apply, args)
    assert torch.autograd.gradgradcheck(apply, args)


def test_contractions_are_adjoints():
    """<phi_loads(phi, t, L), G> = <t, phi_link_term(phi, G, L)>: why each
    is the other's backward."""
    phi, t, dp, L = _operands(2)
    lhs = (ref.phi_loads_ref(phi, t, L) * dp).sum()
    rhs = (t * ref.phi_link_term_ref(phi, dp, L)).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-12, atol=0.0)


def test_autograd_takes_the_gradient_of_only_what_needs_one(monkeypatch):
    """With only t requiring a gradient, phi_loads' backward is one link
    term and forms no outer product in phi."""
    _plain_launches(monkeypatch)
    phi, t, dp, L = _operands(3)
    t.requires_grad_(True)
    calls = []
    monkeypatch.setattr(ops, "phi_link_term", lambda *a: calls.append(a) or ref.phi_link_term_ref(*a))
    (ops._PhiLoads.apply(phi, t, L) * dp).sum().backward()
    assert len(calls) == 1 and calls[0][1] is not None
    torch.testing.assert_close(t.grad, ref.phi_link_term_ref(phi, dp, L), rtol=1e-12, atol=0.0)
    assert phi.grad is None and L.grad is None
