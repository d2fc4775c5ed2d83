"""On the card: the Neumann kernels' streamed layouts (`c8_streamed`) at
V = 1024, where neither kernel's operator block stays on chip, against the
plain version `kernels/neumann/ref.py`.

The operators are the forwarding fractions of one `forwarding_update` on
`random_connected(1024, 256)`: stage k's [1, 256, V, V] view of phi as
the traffic scan and the cost-to-go launch it (N = A = 256), and the
whole phi as one batch of A K = 768 operators. Both kernels run the plain
version's algorithm (hop cap, early exit at its 1e-6 tolerance, freeze) in
another fp32 summation order, so each result is held to the plain one at
1e-5 of its largest element, the same kernel-against-plain tolerance as
`chip_smoke.py`, with TF32 off for the plain version's products. The file
imports no JAX, so it runs on a machine with the card (`python -m pytest
tests/test_torch_neumann_streamed_card.py -m cuda`); without one each test
skips."""
import pytest
import torch

from repro_torch.core import forwarding_update, stack_single, structured_init
from repro_torch.core.flow import _source_injection, _stage_gates, stage_traffic
from repro_torch.core.scenarios import random_connected
from repro_torch.kernels import _build
from repro_torch.kernels.neumann import effective_hops, neumann_propagate, neumann_propagate_ref

V, APPS = 1024, 256
RTOL = 1e-5  # same algorithm, another fp32 summation order
KERNELS = {True: "neumann_cols", False: "neumann_rows"}


@pytest.fixture(scope="module")
def solved():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    prob = stack_single(random_connected(V, APPS, seed=1, device="cuda"))
    state = forwarding_update(prob, structured_init(prob), t_phi=1)
    hops = effective_hops(prob.hop_bound, V, fixed_loop=True)
    yield prob, state, hops
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del prob, state
    torch.cuda.empty_cache()


def _check(w, b, hops, transpose):
    _build.reset_launches()
    got = neumann_propagate(w, b, hops=hops, transpose=transpose)
    assert dict(_build.VARIANT_LAUNCHES[KERNELS[transpose]]) == {"c8_streamed": 1}
    want = neumann_propagate_ref(w, b, hops, 1e-6, transpose)
    scale = want.abs().max().item()
    assert scale > 0 and bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err <= RTOL * scale, f"{KERNELS[transpose]} N={b.numel() // V}: max err {err} > {RTOL} * {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [True, False], ids=["cols", "rows"])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_streamed_stage_solves_match_plain(solved, stage, transpose):
    """Stage k's 256 operators, as forwarding launches them: the traffic
    scan's right-hand side inject_k + gate_k t_{k-1}."""
    prob, state, hops = solved
    t = stage_traffic(prob, state)
    inject, gates = _source_injection(prob), _stage_gates(state, prob.apps)
    t_prev = t[..., stage - 1, :] if stage else torch.zeros_like(t[..., 0, :])
    b = (inject[..., stage, :] + gates[..., stage, :] * t_prev).contiguous()
    _check(state.phi[..., stage, :, :], b, hops, transpose)


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [True, False], ids=["cols", "rows"])
def test_streamed_whole_phi_matches_plain(solved, transpose):
    """All A K = 768 operators of phi in one launch, each against a
    right-hand side drawn from a seed."""
    _, state, hops = solved
    w = state.phi.reshape(-1, V, V)
    gen = torch.Generator(device="cuda").manual_seed(7)
    b = torch.rand(w.shape[0], V, generator=gen, device="cuda")
    _check(w, b, hops, transpose)
