"""On the card: the cost-to-go's two contractions of phi
(csrc/phi_contract.cu) against their plain versions
(kernels/phi_contract/ref.py) on the same CUDA tensors.

`kernels.phi_contract.ops.phi_loads` and `.phi_link_term` launch the
kernels on CUDA tensors; `ref.phi_loads_ref` and `ref.phi_link_term_ref`
are the plain stage loops. The kernels sum in another order than cuBLAS's
gemv and torch's reduction, so each output is held to the plain one within
1e-6 + 1e-5 times the sum of the absolute values of its terms. The cases
cover V from 12 to 5,000 (link-term rows on 4, 8, 16 and 32 lanes, 8 to 32
values a lane, in 16-byte vectors or single columns, then the streamed
walk; load rows in vectors of 4 or single columns), B from 1 to 1,024, the
three benchmark cells' shapes, phantom apps and stages, signed operands,
operands off a 16-byte boundary, padding held bitwise inert, the
gradients of both autograd Functions against the plain versions', Gallager's
identity through `objective_with_injection`, and the launch count inside
`solve_fleet`. The file imports no JAX, so it runs on a machine with the
card (`python -m pytest tests/test_torch_phi_contract_card.py -m cuda`);
without one each test skips."""
import pytest
import torch

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
    # past 1,024 nodes the streamed link-term kernel
    "v1500_b2": (2, 8, 3, 1500),
    "v5000_b1": (1, 4, 3, 5000),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _operands(b, a, k, v, seed, dev, *, signed=False):
    """phi on a sparse random graph over a ring (rows summing to at most
    1), t, dp (0 off the edges) and L drawn from `seed` on the card; the
    last app and every app's last stage phantom (phi 0, t 0). `signed`: t
    and dp in [-1, 1], as a gradient in their place is."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, device=dev)

    idx = torch.arange(v, device=dev)
    adj = (rand(b, v, v) < min(1.0, 4.0 / v)) | ((idx[:, None] - idx[None, :]).abs() == 1)
    adj &= ~torch.eye(v, dtype=torch.bool, device=dev)
    lo = -1.0 if signed else 0.0
    phi = torch.where(adj[:, None, None], rand(b, a, k, v, v), 0.0)
    phi = phi / phi.sum(dim=-1, keepdim=True).clamp_min(1.0)
    t = rand(b, a, k, v, lo=lo, hi=1.0) * 40.0
    dp = torch.where(adj, rand(b, v, v, lo=lo, hi=1.0) * 3.0, 0.0)
    L = rand(b, a, k, lo=0.1, hi=2.0)
    phi[:, -1], phi[:, :, -1] = 0.0, 0.0
    t[:, -1], t[:, :, -1] = 0.0, 0.0
    return phi, t, dp, L


def _assert_within(got, want, scale, what):
    """|got - want| <= 1e-6 + 1e-5 * scale, scale the plain version on the
    absolute values of the terms."""
    assert got.shape == want.shape and got.dtype == torch.float32
    err = (got - want).abs() - (1e-6 + 1e-5 * scale)
    assert bool((err <= 0).all()), f"{what}: worst excess {err.max().item()}"


def _both(phi, t, dp, L):
    """Both kernels against the plain versions, each launched once."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.phi_contract import ops, ref

    before = dict(_build.LAUNCHES)
    F, link = ops.phi_loads(phi, t, L), ops.phi_link_term(phi, dp, L)
    assert _build.LAUNCHES["phi_loads"] == before["phi_loads"] + 1
    assert _build.LAUNCHES["phi_link_term"] == before["phi_link_term"] + 1
    _assert_within(F, ref.phi_loads_ref(phi, t, L), ref.phi_loads_ref(phi, t.abs(), L), "phi_loads")
    _assert_within(link, ref.phi_link_term_ref(phi, dp, L), ref.phi_link_term_ref(phi, dp.abs(), L),
                   "phi_link_term")
    return F, link


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain(case):
    dev = _card()
    b, a, k, v = CASES[case]
    phi, t, dp, L = _operands(b, a, k, v, 1, dev)
    F, link = _both(phi, t, dp, L)
    assert bool((F > 0).any()) and bool((link > 0).any())
    # Phantom apps and stages carry exactly nothing.
    assert not bool(link[:, -1].any()) and not bool(link[:, :, -1].any())
    del phi, t, dp, L, F, link
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("v", [12, 33, 64, 150, 256, 1024, 1500])
def test_kernels_match_plain_on_signed_operands(v):
    """t and dp of either sign, as the incoming gradients of the backward
    passes are: the sums cancel, and the tolerance scales with the terms'
    absolute values."""
    dev = _card()
    _both(*_operands(3, 6, 3, v, 2, dev, signed=True))


@pytest.mark.cuda
def test_kernels_take_views_off_a_16_byte_boundary():
    """Operands that start one float into their storage (the kernels read
    rows in 16-byte vectors) give the same outputs as fresh ones."""
    dev = _card()
    from repro_torch.kernels.phi_contract import ops

    fresh = _operands(3, 5, 3, 64, 3, dev)

    def shifted(t):
        store = torch.empty(t.numel() + 1, device=dev)
        return store[1:].view(t.shape).copy_(t)

    moved = [shifted(t) for t in fresh]
    assert all(t.data_ptr() % 16 for t in moved)
    F, link = _both(*moved)
    phi, t, dp, L = fresh
    assert torch.equal(F, ops.phi_loads(phi, t, L))
    assert torch.equal(link, ops.phi_link_term(phi, dp, L))


@pytest.mark.cuda
@pytest.mark.parametrize("v", [15, 64, 256])
def test_padding_is_bitwise_inert(v):
    """Apps appended with phi 0 and t 0, and a phantom stage, change
    neither F nor the real rows' link terms by a bit."""
    dev = _card()
    from repro_torch.kernels.phi_contract import ops

    b, a, k = 4, 9, 3
    phi, t, dp, L = _operands(b, a, k, v, 4, dev)
    pad_a, pad_k = 5, 1
    phi_p = torch.zeros(b, a + pad_a, k + pad_k, v, v, device=dev)
    t_p = torch.zeros(b, a + pad_a, k + pad_k, v, device=dev)
    L_p = torch.full((b, a + pad_a, k + pad_k), 0.7, device=dev)
    phi_p[:, :a, :k], t_p[:, :a, :k], L_p[:, :a, :k] = phi, t, L
    assert torch.equal(ops.phi_loads(phi_p, t_p, L_p), ops.phi_loads(phi, t, L))
    link_p = ops.phi_link_term(phi_p, dp, L_p)
    assert torch.equal(link_p[:, :a, :k], ops.phi_link_term(phi, dp, L))
    assert not bool(link_p[:, a:].any()) and not bool(link_p[:, :, k:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["phi_loads", "phi_link_term"])
def test_gradients_match_plain(fn):
    """The autograd Functions' gradients in phi, the vector operand and L
    against autograd through the plain versions on the same tensors."""
    dev = _card()
    from repro_torch.kernels.phi_contract import ops, ref

    phi, t, dp, L = _operands(3, 6, 3, 64, 5, dev)
    vec = t if fn == "phi_loads" else dp
    kernel, plain = getattr(ops, fn), getattr(ref, f"{fn}_ref")
    out_shape = (3, 64, 64) if fn == "phi_loads" else (3, 6, 3, 64)
    w = torch.rand(out_shape, generator=torch.Generator(device=dev).manual_seed(6), device=dev) - 0.5
    grads = []
    for f in (kernel, plain):
        leaves = [x.clone().requires_grad_(True) for x in (phi, vec, L)]
        (f(*leaves) * w).sum().backward()
        grads.append([x.grad for x in leaves])
    for name, got, want in zip(("phi", "vec", "L"), *grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item(), msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_cost_to_go_is_gradient(stage):
    """Gallager's identity grad_inj J = q^{a,k} on the card: the gradient
    runs through phi_loads' backward (the link-term kernel) and the Neumann
    solve's transpose-solve backward."""
    _card()
    from repro_torch.core import cost_to_go, forwarding_update, stack_single, structured_init
    from repro_torch.core.flow import objective_with_injection
    from repro_torch.core.scenarios import mesh
    from repro_torch.kernels import _build

    p = stack_single(mesh(device="cuda"))
    s = forwarding_update(p, structured_init(p), t_phi=4)
    q = cost_to_go(p, s)[0]
    a = 3
    inj = torch.zeros(1, p.net.n_nodes, device="cuda", requires_grad=True)
    before = _build.LAUNCHES["phi_link_term"]
    objective_with_injection(p, s, a, stage, inj).sum().backward()
    assert _build.LAUNCHES["phi_link_term"] == before + 1  # the backward's
    torch.testing.assert_close(inj.grad[0], q[0, a, stage], rtol=2e-3, atol=1e-4)


@pytest.mark.cuda
def test_solve_fleet_launches_each_kernel_once_a_cost_to_go(monkeypatch):
    """A small CUDA fleet: each kernel once for the first evaluation and
    t_phi + 1 times a round; J within rtol 1e-5 of the same solve with the
    plain versions forced in."""
    _card()
    from repro_torch.fleet import sample_fleet, solve_fleet
    from repro_torch.kernels import _build
    from repro_torch.kernels.phi_contract import ops, ref

    problems = sample_fleet(6, seed=5, n_range=(12, 24), apps_range=(3, 8), partitions=(1, 2, 3), device="cuda")
    kw = dict(m_max=3, t_phi=4, patience=10, device="cuda")
    solve_fleet(problems, m_max=1, t_phi=1, device="cuda")  # builds and loads the kernels
    _build.reset_launches()
    res = solve_fleet(problems, **kw)
    assert res.rounds == 3
    for name in ("phi_loads", "phi_link_term"):
        assert _build.LAUNCHES[name] == 1 + (kw["t_phi"] + 1) * res.rounds, name
    monkeypatch.setattr(ops, "phi_loads", ref.phi_loads_ref)
    monkeypatch.setattr(ops, "phi_link_term", ref.phi_link_term_ref)
    _build.reset_launches()
    plain = solve_fleet(problems, **kw)
    assert _build.LAUNCHES["phi_loads"] == _build.LAUNCHES["phi_link_term"] == 0
    got, want = torch.as_tensor(res.J), torch.as_tensor(plain.J)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
