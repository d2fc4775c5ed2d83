"""On the card: the sequential placement sweep's kernel (csrc/placement.cu)
gives the plain sweep's hosts bitwise.

`kernels.placement.ops.placement_sweep` launches the kernel on CUDA
tensors; `kernels.placement.ref.sequential_sweep` is the plain scan. Both
run on the same CUDA tensors and their hosts must be `torch.equal`: hosts
are discrete, and one flipped near-tie changes J. The cases cover the
chain and the co-located walk, split depths 1-3 with phantom partitions,
V from 12 to 5,000 (one to 32 warps a lane, then 2-8 nodes a thread), B
from 1 to 1,024, the M/M/1 marginal with loads past the knee and the
linear cost, a symmetric ring whose scores tie exactly, and the sweep
inside a solved fleet. The file
imports no JAX, so it runs on a machine with the card (`python -m pytest
tests/test_torch_placement_sweep_card.py -m cuda`); without one each test
skips."""
import pytest
import torch

from repro_torch.core.structs import Apps, CostModel, Network, Problem

CASES = {
    # name: (B, V, A, P, depths)
    "v12_b1": (1, 12, 5, 3, (1, 2, 3)),
    "v64_b16": (16, 64, 24, 2, (1, 2)),
    "v64_b1024": (1024, 64, 24, 2, (2,)),
    "v256_b16": (16, 256, 128, 2, (2,)),
    "v256_b1_mixed": (1, 256, 40, 3, (1, 2, 3)),
    "v1024_b1": (1, 1024, 16, 3, (1, 2, 3)),
    # past 1,024 nodes each thread owns 2, 4 or 8 of them
    "v1500_b2": (2, 1500, 8, 2, (1, 2)),
    "v3000_b1": (1, 3000, 6, 2, (2,)),
    "v5000_b1": (1, 5000, 6, 3, (1, 2, 3)),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _synthetic(b, v, a, p, depths, kind, seed, *, ring=False, dev):
    """Sweep inputs drawn from `seed`: a problem whose apps have split depths
    from `depths`, old hosts, a distance table and a node load G of which
    about a third lies past the M/M/1 knee. `ring`: hop distances on a
    cycle, uniform rates and weights and no load, so scores tie exactly."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=g)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=g)

    parts = torch.tensor(depths)[ints(len(depths), b, a)]
    if ring:
        idx = torch.arange(v)
        gap = (idx[:, None] - idx[None, :]).abs()
        dist = torch.minimum(gap, v - gap).float().expand(b, v, v)
        nu = torch.full((b, v), 2.0)
        L = torch.ones(b, a, p + 1)
        w = torch.ones(b, a, p)
        lam = torch.ones(b, a)
        G = torch.zeros(b, v)
    else:
        dist = rand(b, v, v, lo=0.5, hi=4.0)
        idx = torch.arange(v)
        dist[:, idx, idx] = 0.0
        nu = rand(b, v, lo=1.0, hi=3.0)
        L = rand(b, a, p + 1, lo=0.1, hi=2.0)
        w = rand(b, a, p, lo=0.1, hi=1.0)
        lam = rand(b, a, lo=0.05, hi=0.5)
        G = nu * rand(b, v, lo=0.0, hi=1.4)
    w = torch.where(torch.arange(p) < parts[..., None], w, 0.0)  # phantom partitions weigh nothing
    rho = 0.95 if seed % 2 else rand(b, lo=0.85, hi=0.95).to(dev)
    w_comp = 1.0 if seed % 2 else rand(b, lo=0.5, hi=2.0).to(dev)
    apps = Apps(src=ints(v, b, a), dst=ints(v, b, a), lam=lam, L=L, w=w, parts=parts)
    problem = Problem(
        net=Network(adj=torch.zeros(b, v, v, device=dev), mu=torch.ones(b, v, v, device=dev), nu=nu.to(dev)),
        apps=Apps(**{k: getattr(apps, k).to(dev) for k in ("src", "dst", "lam", "L", "w", "parts")}),
        cost=CostModel(kind=kind, rho_max=rho, w_comp=w_comp),
    )
    hosts = ints(v, b, a, p)
    return problem, hosts.to(dev), dist.contiguous().to(dev), G.to(dev)


def _both(problem, hosts, dist, G, colocate):
    from repro_torch.core.placement import comp_marginal
    from repro_torch.kernels import _build
    from repro_torch.kernels.placement import ops, ref

    cprime = comp_marginal(problem)
    before = _build.LAUNCHES["placement_sweep"]
    got = ops.placement_sweep(problem, hosts, dist, G, cprime, colocate=colocate, move_margin=0.02)
    assert _build.LAUNCHES["placement_sweep"] == before + 1
    want = ref.sequential_sweep(problem, hosts, dist, G, cprime, colocate=colocate, move_margin=0.02)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mm1", "linear"])
@pytest.mark.parametrize("colocate", [False, True], ids=["chain", "colocated"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_hosts_bitwise_equal_plain(case, colocate, kind):
    dev = _card()
    b, v, a, p, depths = CASES[case]
    for seed in (1, 2):
        problem, hosts, dist, G = _synthetic(b, v, a, p, depths, kind, seed, dev=dev)
        got, want = _both(problem, hosts, dist, G, colocate)
        assert got.dtype == torch.int64 and got.shape == hosts.shape
        assert torch.equal(got, want), (seed, int((got != want).sum()))
        assert bool((want != hosts).any())  # the sweep moves hosts


@pytest.mark.cuda
@pytest.mark.parametrize("colocate", [False, True], ids=["chain", "colocated"])
@pytest.mark.parametrize("v", [12, 64, 256])
def test_kernel_ties_on_a_symmetric_ring(v, colocate):
    """Uniform rates on a cycle: many nodes score the same, so the first
    minimum and the hysteresis against the old host's equal score decide."""
    dev = _card()
    problem, hosts, dist, G = _synthetic(4, v, 16, 2, (1, 2), "mm1", 1, ring=True, dev=dev)
    got, want = _both(problem, hosts, dist, G, colocate)
    assert torch.equal(got, want)
    assert bool((want != hosts).any()) and bool((want == hosts).any())


@pytest.mark.cuda
@pytest.mark.parametrize("colocate", [False, True], ids=["chain", "colocated"])
def test_kernel_on_a_padded_mixed_fleet(colocate):
    """A stacked fleet of split depths 1-3 (phantom partitions, pad nodes
    and pad apps) at its refined state: the operands `placement_update`
    forms, through both sweeps, and through `placement_update` itself."""
    _card()
    from repro_torch import core as T
    from repro_torch.fleet import sample_fleet, stack_problems
    from repro_torch.kernels.minplus import apsp_with_nexthop

    st, _ = stack_problems(sample_fleet(8, seed=4, partitions=(1, 2, 3), device="cuda"))
    s0 = T.forwarding_update(st, T.structured_init(st, colocate=colocate), t_phi=2)
    _, aux = T.round_eval(st, s0)
    dist, _ = apsp_with_nexthop(aux["ctg"][1])
    got, want = _both(st, s0.hosts(), dist, aux["ctg"][5], colocate)
    assert torch.equal(got, want)
    assert torch.equal(T.placement_update(st, s0, aux["ctg"], colocate=colocate).hosts(), got)


@pytest.mark.cuda
def test_solve_fleet_launches_one_sweep_a_round():
    """A small CUDA fleet: one kernel launch a trip of the round loop, none
    in the structured init (a DP, not a sweep)."""
    _card()
    from repro_torch.fleet import sample_fleet, solve_fleet
    from repro_torch.kernels import _build

    problems = sample_fleet(6, seed=5, n_range=(12, 24), apps_range=(3, 8), partitions=(1, 2, 3), device="cuda")
    solve_fleet(problems, m_max=2, t_phi=2, device="cuda")  # builds and loads the kernels
    _build.reset_launches()
    res = solve_fleet(problems, m_max=4, t_phi=2, patience=10, device="cuda")
    assert res.rounds == 4
    assert _build.LAUNCHES["placement_sweep"] == res.rounds
