"""The port's slice as a whole: the four methods against the JAX package on
the four paper topologies, the paper's claims on the port, and the batched
engine's lane independence, on the CPU."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import to_torch_problem
from repro import core as J
from repro_torch import core as T
from repro_torch.fleet import stack_problems, unify_hop_bound

jax.config.update("jax_enable_x64", False)

NAMES = list(J.SCENARIOS)


@pytest.fixture(scope="module")
def port_results():
    """compare_all of every paper topology on the port, solved once."""
    return {
        name: T.compare_all(T.SCENARIOS[name](device="cpu"), device="cpu") for name in NAMES
    }


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("jax_solver", ["neumann", "lu"])
def test_compare_all_matches_jax(name, jax_solver, port_results):
    """J of all four methods at rtol 1e-5, against JAX's default path and
    its dense-LU path."""
    want = J.compare_all(J.SCENARIOS[name](), solver=jax_solver)
    got = port_results[name]
    for method in J.ALL_METHODS:
        np.testing.assert_allclose(got[method].J, want[method].J, rtol=1e-5, err_msg=method)
        np.testing.assert_allclose(got[method].J_comm, want[method].J_comm, rtol=1e-5, err_msg=method)
        np.testing.assert_allclose(got[method].J_comp, want[method].J_comp, rtol=1e-5, err_msg=method)
        assert np.array_equal(got[method].state.hosts().numpy(), np.asarray(want[method].state.hosts()))
        if jax_solver == "neumann":
            assert got[method].iters == want[method].iters, method


def test_port_lu_solver_matches_jax_lu():
    p = J.geant()
    want = J.solve_alt(p, solver="lu", m_max=6)
    got = T.solve_alt(to_torch_problem(p), solver="lu", m_max=6, device="cpu")
    np.testing.assert_allclose(got.J, want.J, rtol=1e-5)


def test_alt_beats_all_baselines_everywhere(port_results):
    for name, res in port_results.items():
        alt = res["ALT"]
        assert alt.J <= alt.history[0] + 1e-6, name
        for other in ("OneShot", "CongUnaware", "CoLocated"):
            assert alt.J <= res[other].J * 1.001, (name, other, alt.J, res[other].J)


def test_split_flexibility_matters_most_in_iot(port_results):
    ratio = {n: port_results[n]["CoLocated"].J / port_results[n]["ALT"].J for n in ("iot", "geant")}
    assert ratio["iot"] > ratio["geant"]


def test_load_widens_absolute_gap(port_results):
    half = T.iot(load_scale=0.5, device="cpu")
    gaps = [
        T.solve_congunaware(half, device="cpu").J - T.solve_alt(half, device="cpu").J,
        port_results["iot"]["CongUnaware"].J - port_results["iot"]["ALT"].J,
    ]
    assert gaps[1] > gaps[0] > 0


# ---------------------------------------------------------------------------
# The batched engine: lanes are independent, frozen lanes are inert.
# ---------------------------------------------------------------------------
ENGINE_KW = dict(m_max=6, t_phi=3, alpha=0.5, tol=1e-3, patience=2, device="cpu")


def _instances():
    return [T.random_connected(20, 6, seed=s, device="cpu") for s in range(3)]


def _assert_lane_equal(batch, i, single):
    for k in ("J", "J_comm", "J_comp", "hosts", "iters"):
        assert torch.equal(batch[k][i], single[k][0]), k
    assert torch.equal(batch["history"][i].isnan(), single["history"][0].isnan())
    assert torch.equal(batch["history"][i].nan_to_num(), single["history"][0].nan_to_num())
    assert torch.equal(batch["state"].phi[i], single["state"].phi[0])


def test_engine_batch_equals_single_lanes_bitwise():
    probs = _instances()
    hb = unify_hop_bound(probs)
    out = T.engine_solve(stack_problems(probs), **ENGINE_KW)
    assert out["J"].shape == (3,) and out["history"].shape == (3, 7)
    assert out["trace"] is None and out["rounds"] == int(out["iters"].max())
    for i, p in enumerate(probs):
        one = T.engine_solve(stack_problems([dataclasses.replace(p, hop_bound=hb)]), **ENGINE_KW)
        _assert_lane_equal(out, i, one)


def test_engine_frozen_lanes_inert():
    probs = _instances()
    stacked = stack_problems(probs)
    full = T.engine_solve(stacked, **ENGINE_KW)
    out = T.engine_solve(stacked, active0=torch.tensor([True, False, True]), **ENGINE_KW)
    assert int(out["iters"][1]) == 0
    assert float(out["J"][1]) == float(out["history"][1, 0])
    assert bool(out["history"][1, 1:].isnan().all())
    for i in (0, 2):
        for k in ("J", "hosts", "iters"):
            assert torch.equal(out[k][i], full[k][i]), k
    # NaN past each lane's freeze point.
    for i in range(3):
        n = int(full["iters"][i])
        assert not bool(full["history"][i, : n + 1].isnan().any())
        assert bool(full["history"][i, n + 1:].isnan().all())


def test_engine_warm_start_from_state():
    probs = _instances()
    stacked = stack_problems(probs)
    first = T.engine_solve(stacked, **ENGINE_KW)
    warm = T.engine_solve(stacked, init_state=first["state"], **ENGINE_KW)
    torch.testing.assert_close(warm["history"][:, 0], first["J"], rtol=1e-5, atol=0)
    assert bool((warm["J"] <= first["J"] * (1 + 1e-6)).all())


def test_unknown_kwargs_raise():
    p = T.iot(device="cpu")
    with pytest.raises(TypeError, match="unknown solver kwargs"):
        T.compare_all(p, device="cpu", m_maxx=3)
    with pytest.raises(TypeError, match="unknown solver kwargs"):
        T.compare_all(p, device="cpu", use_pallas=True)


def test_blocked_sweep_not_ported_raises():
    p = T.iot(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.solve_alt(p, block_apps=4, m_max=2, device="cpu")


def test_stack_problems_rejects_ragged_and_mixed():
    a = T.random_connected(12, 4, seed=0, device="cpu")
    with pytest.raises(ValueError, match="one \\(V, A, P\\) shape"):
        stack_problems([a, T.random_connected(14, 4, seed=0, device="cpu")])
    lin = dataclasses.replace(a, cost=T.CostModel(kind="linear"))
    with pytest.raises(ValueError, match="mixes cost kinds"):
        stack_problems([a, lin])
    with pytest.raises(ValueError, match="empty"):
        stack_problems([])
    s = stack_problems([a, dataclasses.replace(a, hop_bound=None)])
    assert s.hop_bound == max(a.hop_bound, a.net.n_nodes + 1)
    assert s.cost.rho_max.shape == (2,)
