"""On the card: the forwarding sweep's kernel (csrc/forwarding.cu) against
the plain tail (kernels/forwarding/ref.py) on the same CUDA tensors.

`kernels.forwarding.ops.update_phi` launches the kernel on CUDA tensors;
`kernels.forwarding.ref.update_phi_ref` is the plain tail. Every entry off
the minimum-marginal column j* must be `torch.equal` (each is the same
chain of fp32 roundings); the j* entry, which takes the freed mass after a
row sum in another order, agrees to atol 1e-6 / rtol 1e-5. The kernel's j*
is read directly: from phi = 0 and unit mass it returns one_hot(j*). The
cases cover V from 12 to 5,000 (rows on 4, 8, 16 and 32 lanes, 8 to 32
values a lane, in 16-byte vectors or single columns, then the streamed
walk), B from 1 to 1,024, the three benchmark cells'
shapes, phantom apps and stages (mass 0), delta ties, rows with no live
out-edge, entries either side of the 1e-9 prune, the M/M/1 and linear
costs in a padded fleet, operands off a 16-byte boundary, and the sweep
inside `solve_fleet`. The file
imports no JAX, so it runs on a machine with the card (`python -m pytest
tests/test_torch_forwarding_sweep_card.py -m cuda`); without one each test
skips."""
import dataclasses

import pytest
import torch

from repro_torch.core.structs import BIG, CostModel, one_hot

CASES = {
    # name: (B, A, K, V)
    "v12_b4": (4, 5, 3, 12),
    "v15_b6": (6, 4, 2, 15),
    "v32_b327": (327, 10, 4, 32),
    "v33_b3": (3, 7, 3, 33),
    "v64_b1024": (1024, 24, 3, 64),  # fleet64.replan
    "v75_b5": (5, 6, 3, 75),
    "v100_b8": (8, 6, 4, 100),
    "v150_b4": (4, 9, 3, 150),
    "v256_b16": (16, 128, 3, 256),  # tier256.replan
    "v301_b2": (2, 10, 3, 301),
    "v500_b2": (2, 20, 3, 500),
    "v777_b1": (1, 17, 3, 777),
    "v1024_b1": (1, 256, 3, 1024),  # backbone1024.replan
    # past 1,024 nodes the streamed kernel
    "v1500_b2": (2, 8, 3, 1500),
    "v5000_b1": (1, 4, 3, 5000),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _operands(b, a, k, v, seed, dev, *, ties=False):
    """Sweep inputs drawn from `seed` on the card: a sparse random graph
    over a ring, every seventh row from node 3 without a live out-edge; the
    last app and every app's last stage phantom (mass 0, phi 0); phi on the
    edges summing to the mass, a twentieth of its entries within a factor 3
    of 1e-9. `ties`: integer q and dp and unit L, so deltas tie exactly."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, device=dev)

    idx = torch.arange(v, device=dev)
    ring = (idx[:, None] - idx[None, :]).abs() == 1
    adj = (rand(b, v, v) < min(1.0, 4.0 / v)) | ring
    adj &= ~torch.eye(v, dtype=torch.bool, device=dev)
    adj[:, idx % 7 == 3, :] = False
    if ties:
        dp = torch.randint(1, 3, (b, v, v), generator=g, device=dev).float()
        q = torch.randint(0, 4, (b, a, k, v), generator=g, device=dev).float()
        L = torch.ones(b, a, k, device=dev)
    else:
        dp = rand(b, v, v, lo=0.2, hi=3.0)
        q = rand(b, a, k, v, lo=0.0, hi=20.0)
        L = rand(b, a, k, lo=0.1, hi=2.0)
    dp = torch.where(adj, dp, BIG)
    mass = rand(b, a, k, v)
    mass[:, -1] = 0.0
    mass[:, :, -1] = 0.0
    phi = torch.where(adj[:, None, None], rand(b, a, k, v, v), 0.0)
    phi = phi / phi.sum(dim=-1, keepdim=True).clamp_min(1e-30) * mass[..., None]
    tiny = adj[:, None, None] & (rand(b, a, k, v, v) < 0.05)
    phi = torch.where(tiny & (mass[..., None] > 0), rand(b, a, k, v, v, lo=1e-9 / 3, hi=3e-9), phi)
    return phi, q, dp, L, adj.float(), mass


def _both(phi, q, dp, L, adj, mass, alpha=0.5):
    """The kernel's and the plain tail's phi, and the plain j*, after
    checking that the kernel launched once and picks the plain j*."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.forwarding import ops, ref

    v = phi.shape[-1]
    before = _build.LAUNCHES["forwarding_sweep"]
    got = ops.update_phi(phi, q, dp, L, adj, mass, alpha)
    assert _build.LAUNCHES["forwarding_sweep"] == before + 1
    want = ref.update_phi_ref(phi, q, dp, L, adj, mass, alpha)
    jstar = ref.link_delta(q, dp, L, adj).argmin(dim=-1)
    picked = ops.update_phi(torch.zeros_like(phi), q, dp, L, adj, torch.ones_like(mass), alpha)
    assert torch.equal(picked, one_hot(jstar, v)), "the kernel's j* is not the plain argmin"
    return got, want, jstar


def _assert_matches(got, want, jstar):
    assert got.shape == want.shape and got.dtype == torch.float32
    at = one_hot(jstar, want.shape[-1]).bool()
    off = ~at
    assert torch.equal(got[off], want[off]), int((got[off] != want[off]).sum())
    torch.testing.assert_close(got[at], want[at], atol=1e-6, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_tail(case):
    dev = _card()
    b, a, k, v = CASES[case]
    phi, q, dp, L, adj, mass = _operands(b, a, k, v, 1, dev)
    got, want, jstar = _both(phi, q, dp, L, adj, mass)
    _assert_matches(got, want, jstar)
    # The prune bites, and entries just above it survive.
    assert bool(((phi > 1e-9) & (want == 0)).any())
    assert bool(((want >= 1e-9) & (want < 2e-9)).any())
    # Rows without a live out-edge send everything to node 0.
    assert bool((jstar[:, :, :, 3] == 0).all())
    del phi, q, dp, got, want, jstar
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("v", [12, 33, 64, 150, 256, 1024, 1500])
def test_kernel_ties_take_the_lowest_index(v):
    """Integer marginals: many deltas of a row tie, and j* is the first."""
    dev = _card()
    phi, q, dp, L, adj, mass = _operands(2, 6, 3, v, 2, dev, ties=True)
    delta = torch.where(adj[:, None, None] > 0, dp[:, None, None] + q[..., None, :], BIG)
    n_min = (delta == delta.amin(dim=-1, keepdim=True)).sum(dim=-1)
    assert bool((n_min > 1).float().mean() > 0.3)
    got, want, jstar = _both(phi, q, dp, L, adj, mass, alpha=0.7)
    _assert_matches(got, want, jstar)


@pytest.mark.cuda
def test_kernel_takes_views_off_a_16_byte_boundary():
    """Operands that start one float into their storage (the kernel reads
    rows in 16-byte vectors) give the same phi as fresh ones."""
    dev = _card()
    ops_in = _operands(3, 5, 3, 64, 3, dev)

    def shifted(t):
        store = torch.empty(t.numel() + 1, device=dev)
        return store[1:].view(t.shape).copy_(t)

    moved = [shifted(t) for t in ops_in]
    assert all(t.data_ptr() % 16 for t in moved)
    got, want, jstar = _both(*moved)
    _assert_matches(got, want, jstar)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mm1", "linear"])
def test_kernel_on_a_padded_fleet(kind):
    """A stacked fleet of split depths 1-3 (phantom partitions, pad nodes
    and pad apps) under either cost: the operands `forwarding_sweep` forms
    after two sweeps."""
    _card()
    from repro_torch import core as T
    from repro_torch.fleet import sample_fleet, stack_problems

    problems = sample_fleet(8, seed=4, partitions=(1, 2, 3), device="cuda")
    problems = [dataclasses.replace(p, cost=CostModel(kind=kind)) for p in problems]
    st, _ = stack_problems(problems)
    s = T.forwarding_update(st, T.structured_init(st), t_phi=2)
    q, dp, *_ = T.cost_to_go(st, s)
    mass = T.forwarding_mass(s, st.apps, st.net.n_nodes)
    assert bool((mass == 0).any())  # phantom apps and stages
    got, want, jstar = _both(s.phi, q, dp, st.apps.L, st.net.adj, mass)
    _assert_matches(got, want, jstar)


@pytest.mark.cuda
def test_solve_fleet_launches_one_kernel_a_sweep(monkeypatch):
    """A small CUDA fleet: t_phi launches a round, none in the init; J
    within rtol 1e-5 of the same solve with the plain tail forced in."""
    _card()
    from repro_torch.fleet import sample_fleet, solve_fleet
    from repro_torch.kernels import _build
    from repro_torch.kernels.forwarding import ops, ref

    problems = sample_fleet(6, seed=5, n_range=(12, 24), apps_range=(3, 8), partitions=(1, 2, 3), device="cuda")
    kw = dict(m_max=3, t_phi=4, patience=10, device="cuda")
    solve_fleet(problems, m_max=1, t_phi=1, device="cuda")  # builds and loads the kernels
    _build.reset_launches()
    res = solve_fleet(problems, **kw)
    assert res.rounds == 3
    assert _build.LAUNCHES["forwarding_sweep"] == kw["t_phi"] * res.rounds
    monkeypatch.setattr(ops, "update_phi", ref.update_phi_ref)
    plain = solve_fleet(problems, **kw)
    got, want = torch.as_tensor(res.J), torch.as_tensor(plain.J)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
