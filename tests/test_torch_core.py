"""Port parity, module by module, on the four paper topologies: the JAX
package's state is carried across (tests/_torch_bridge.py) and fed to the
port's flow, marginals, forwarding and placement, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import to_torch_problem, to_torch_state
from repro import core as J
from repro.core.marginals import cost_to_go as j_cost_to_go
from repro_torch import core as T
from repro_torch.core.structs import BIG_THRESHOLD

jax.config.update("jax_enable_x64", False)

NAMES = list(J.SCENARIOS)


def _pair(name):
    """(JAX problem, JAX refined state, port stacked problem, port state)."""
    jp = J.SCENARIOS[name]()
    js = J.forwarding_update(jp, J.structured_init(jp), t_phi=3)
    tp = T.stack_single(to_torch_problem(jp))
    ts = to_torch_state(js)
    return jp, js, tp, T.State(x=ts.x[None], phi=ts.phi[None])


def _close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", NAMES)
def test_flow_and_objective_parity(name):
    jp, js, tp, ts = _pair(name)
    t_j = J.stage_traffic(jp, js)
    t_t = T.stage_traffic(tp, ts)
    scale = float(jnp.max(jnp.abs(t_j)))
    _close(t_t, t_j, atol=1e-6 * scale)
    F_j, G_j = J.loads(jp, js, t_j)
    F_t, G_t = T.loads(tp, ts, t_t)
    _close(F_t, F_j, atol=1e-6 * float(jnp.max(F_j)))
    _close(G_t, G_j, atol=1e-6 * float(jnp.max(G_j)))
    J_j, aux_j = J.objective(jp, js)
    J_t, aux_t = T.objective(tp, ts)
    for k in ("J", "J_comm", "J_comp"):
        _close(aux_t[k], aux_j[k])
    # The dense LU reference path agrees too.
    _close(T.objective(tp, ts, solver="lu")[0], J.objective(jp, js, solver="lu")[0])


@pytest.mark.parametrize("name", NAMES)
def test_cost_to_go_parity(name):
    jp, js, tp, ts = _pair(name)
    q_j, dp_j, kappa_j, *_ = j_cost_to_go(jp, js)
    q_t, dp_t, kappa_t, *_ = T.cost_to_go(tp, ts)
    _close(q_t, q_j, atol=1e-6 * float(jnp.max(jnp.abs(q_j))))
    _close(dp_t, dp_j)
    _close(kappa_t, kappa_j)


@pytest.mark.parametrize("name", NAMES)
def test_forwarding_sweep_parity(name):
    jp, js, tp, ts = _pair(name)
    want = J.forwarding_sweep(jp, js, alpha=0.5)
    got = T.forwarding_sweep(tp, ts, alpha=0.5)
    _close(got.phi, want.phi, rtol=0, atol=1e-6)
    assert torch.equal(got.x, ts.x)
    want = J.forwarding_update(jp, js, t_phi=3)
    got = T.forwarding_update(tp, ts, t_phi=3)
    _close(got.phi, want.phi, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("colocate", [False, True])
def test_structured_init_hosts_bitwise(name, colocate):
    """The squaring APSP (the JAX `use_pallas` algorithm) and first-minimum
    next hops reproduce the JAX init exactly: hosts and the SP-tree phi."""
    jp = J.SCENARIOS[name]()
    tp = T.stack_single(to_torch_problem(jp))
    got = T.structured_init(tp, colocate=colocate)
    for kw in ({"use_pallas": True, "interpret": True}, {}):
        want = J.structured_init(jp, colocate=colocate, **kw)
        assert np.array_equal(got.hosts()[0].numpy(), np.asarray(want.hosts())), kw
        assert np.array_equal(got.phi[0].numpy(), np.asarray(want.phi)), kw


@pytest.mark.parametrize("name", NAMES)
def test_placement_update_parity(name):
    """Hosts agree wherever JAX's decision clears move_margin; the port is
    fed the same carried state and computes its own marginals."""
    jp, js, tp, ts = _pair(name)
    want = J.placement_update(jp, js)
    got = T.placement_update(tp, ts)
    h_j, h_t = np.asarray(want.hosts()), got.hosts()[0].numpy()
    assert np.array_equal(h_t, h_j)
    # Every rebuilt stage equals JAX's SP tree; kept stages are untouched.
    _close(got.phi, want.phi, rtol=0, atol=1e-6)
    absorbed = T.total_absorbed(tp, got)
    _close(absorbed, jp.apps.lam, rtol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_round_eval_parity(name):
    jp, js, tp, ts = _pair(name)
    J_j, aux_j = J.round_eval(jp, js)
    J_t, aux_t = T.round_eval(tp, ts)
    for k in ("J", "J_comm", "J_comp"):
        _close(aux_t[k], aux_j[k])


# ---------------------------------------------------------------------------
# Invariants of repro's tests/test_core.py, held on the port alone.
# ---------------------------------------------------------------------------
def _mass_violation(p, s):
    mass = T.forwarding_mass(s, p.apps, p.net.n_nodes)
    return float((s.phi.sum(dim=-1) - mass).abs().max())


@pytest.mark.parametrize("name", NAMES)
def test_invariants_on_the_port(name):
    p = T.stack_single(T.SCENARIOS[name](device="cpu"))
    s = T.structured_init(p)
    assert _mass_violation(p, s) < 1e-5
    assert float(s.phi.min()) >= 0.0
    torch.testing.assert_close(s.x.sum(dim=-1), torch.ones_like(s.x[..., 0]))
    for _ in range(5):
        s = T.forwarding_sweep(p, s, alpha=0.5)
    assert _mass_violation(p, s) < 1e-4  # conservation
    np.testing.assert_allclose(T.total_absorbed(p, s).numpy(), p.apps.lam.numpy(), rtol=1e-4)
    off_edge = torch.where(p.net.adj[:, None, None] > 0, 0.0, s.phi)
    assert float(off_edge.abs().max()) == 0.0  # phi only on edges
    assert float(T.stage_traffic(p, s).min()) >= -1e-6
    s2 = T.placement_update(p, s)
    np.testing.assert_allclose(T.total_absorbed(p, s2).numpy(), p.apps.lam.numpy(), rtol=1e-4)


def test_delta_min_always_proper():
    """The argmin out-link survives the blocking rule (q_j* < q_i)."""
    p = T.stack_single(T.iot(device="cpu"))
    s = T.forwarding_update(p, T.structured_init(p), t_phi=3)
    delta, aux = T.link_marginals(p, s)
    q = aux["q"]
    q_star = torch.gather(q, -1, delta.argmin(dim=-1))
    mass = T.forwarding_mass(s, p.apps, p.net.n_nodes)
    assert not bool(((q_star >= q) & (mass > 1e-6)).any())
    assert bool((delta.amin(dim=-1)[mass > 1e-6] < BIG_THRESHOLD).all())


def test_repair_phi_force_rebuilds_stage():
    """`force` rebuilds a stage whose target did not move."""
    p = T.stack_single(T.mesh(device="cpu"))
    s = T.forwarding_update(p, T.structured_init(p), t_phi=3)
    from repro_torch.kernels.minplus import apsp_with_nexthop

    _, nexthop = apsp_with_nexthop(T.zero_load_dp(p))
    force = torch.zeros(s.phi.shape[:-2], dtype=torch.bool)
    assert torch.equal(T.repair_phi(p, s, s, nexthop).phi, s.phi)
    force[0, 2, 0] = True
    rebuilt = T.repair_phi(p, s, s, nexthop, force).phi
    assert torch.equal(rebuilt[0, :2], s.phi[0, :2])
    assert torch.equal(rebuilt[0, 2, 0], T.structured_init(p).phi[0, 2, 0])
