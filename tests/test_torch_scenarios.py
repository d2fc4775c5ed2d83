"""Port parity: scenario arrays, the networkx-free Watts-Strogatz copy,
costs and masks (repro_torch.core vs repro.core, on the CPU)."""
import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from _torch_bridge import problem_arrays, to_torch_problem, to_torch_state
from repro.core import costs as jcosts
from repro.core import scenarios as jscen
from repro.core import structs as jstructs
from repro.core import structured_init as j_structured_init
from repro_torch.core import _graphs, costs as tcosts, scenarios as tscen, structs as tstructs
from repro_torch.core import stack_single

jax.config.update("jax_enable_x64", False)


def _assert_same_arrays(jp, tp):
    ja, ta = problem_arrays(jp), tp.to_numpy()
    assert set(ja) == set(ta)
    for k in ja:
        if k.startswith("cost."):
            np.testing.assert_array_equal(np.float32(ja[k]), np.float32(ta[k]), err_msg=k)
        else:
            assert ja[k].dtype == ta[k].dtype, (k, ja[k].dtype, ta[k].dtype)
            np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
    assert jp.hop_bound == tp.hop_bound
    assert jp.cost.kind == tp.cost.kind


@pytest.mark.parametrize("name", list(jscen.SCENARIOS))
def test_paper_scenarios_bitwise(name):
    _assert_same_arrays(jscen.SCENARIOS[name](), tscen.SCENARIOS[name](device="cpu"))


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_connected_bitwise(n, seed):
    _assert_same_arrays(
        jscen.random_connected(n, 8, seed=seed),
        tscen.random_connected(n, 8, seed=seed, device="cpu"),
    )


def test_scenario_options_bitwise():
    """load_scale, a cost model and a non-default split depth carry over."""
    cm_j = jstructs.CostModel(w_comm=0.3, w_comp=0.7)
    cm_t = tstructs.CostModel(w_comm=0.3, w_comp=0.7)
    _assert_same_arrays(
        jscen.geant(load_scale=0.6, cost=cm_j, n_parts=3),
        tscen.geant(load_scale=0.6, cost=cm_t, n_parts=3, device="cpu"),
    )


@pytest.mark.parametrize(
    "n,k,p,seed",
    [(30, 4, 0.1, 7), (32, 4, 0.3, 0), (64, 4, 0.3, 2), (12, 2, 0.5, 3),
     (20, 6, 0.9, 11), (9, 8, 0.7, 5), (40, 5, 0.3, 4), (8, 8, 0.2, 1)],
)
def test_watts_strogatz_copy_edge_order(n, k, p, seed):
    """Same edges in the same order as networkx (mu is drawn per edge in
    that order)."""
    want = list(nx.connected_watts_strogatz_graph(n, k, p, seed=seed).edges())
    got = _graphs.edges(_graphs.connected_watts_strogatz_graph(n, k, p, seed=seed))
    assert got == want


@pytest.mark.parametrize("kind", ["mm1", "linear"])
def test_costs_match_on_knee_grid(kind):
    """Costs and derivatives on a grid straddling the knee rho_max * cap."""
    cap = np.array([0.5, 2.0, 10.0, 1e18], np.float32)[:, None]
    load = (cap * np.linspace(0.0, 1.6, 81, dtype=np.float32)[None, :]).astype(np.float32)
    load[3] = np.linspace(0.0, 30.0, 81, dtype=np.float32)  # off-edge BIG rate
    cap = np.broadcast_to(cap, load.shape).copy()
    cm_j = jstructs.CostModel(kind=kind, rho_max=0.9)
    cm_t = tstructs.CostModel(kind=kind, rho_max=0.9)
    for jf, tf in (
        (jcosts.link_cost, tcosts.link_cost),
        (jcosts.link_cost_prime, tcosts.link_cost_prime),
        (jcosts.comp_cost, tcosts.comp_cost),
        (jcosts.comp_cost_prime, tcosts.comp_cost_prime),
    ):
        want = np.asarray(jf(jnp.asarray(load), jnp.asarray(cap), cm_j))
        got = tf(torch.from_numpy(load), torch.from_numpy(cap), cm_t).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=tf.__name__)


def test_costs_batched_rho_max():
    """A stacked [B] rho_max is viewed against [B, V, V] loads."""
    rho = torch.tensor([0.8, 0.95])
    load = torch.linspace(0.0, 2.0, 18).reshape(2, 3, 3)
    cap = torch.ones_like(load)
    got = tcosts.link_cost(load, cap, tstructs.CostModel(rho_max=rho))
    for b in range(2):
        want = tcosts.link_cost(load[b], cap[b], tstructs.CostModel(rho_max=float(rho[b])))
        torch.testing.assert_close(got[b], want, rtol=0, atol=0)


@pytest.mark.parametrize("name", list(jscen.SCENARIOS))
def test_masks_and_forwarding_mass_equal(name):
    jp = jscen.SCENARIOS[name](n_parts=3)
    js = j_structured_init(jp)
    tp, ts = to_torch_problem(jp), to_torch_state(js)
    for jf, tf in (
        (jstructs.app_live_mask, tstructs.app_live_mask),
        (jstructs.partition_live_mask, tstructs.partition_live_mask),
        (jstructs.stage_live_mask, tstructs.stage_live_mask),
    ):
        np.testing.assert_array_equal(np.asarray(jf(jp.apps)), tf(tp.apps).numpy())
    np.testing.assert_array_equal(
        np.asarray(jstructs.stage_targets(jp.apps, js.hosts())),
        tstructs.stage_targets(tp.apps, ts.hosts()).numpy(),
    )
    n = jp.net.n_nodes
    np.testing.assert_array_equal(
        np.asarray(jstructs.forwarding_mass(js, jp.apps, n)),
        tstructs.forwarding_mass(ts, tp.apps, n).numpy(),
    )
    # Batched: the same masks under a leading instance axis.
    st = stack_single(tp)
    np.testing.assert_array_equal(
        tstructs.forwarding_mass(tstructs.State(x=ts.x[None], phi=ts.phi[None]), st.apps, n)[0].numpy(),
        np.asarray(jstructs.forwarding_mass(js, jp.apps, n)),
    )


def test_one_hot_out_of_range_is_zero_like_jax():
    idx = np.array([0, 3, -1, 4], np.int32)
    want = np.asarray(jstructs.one_hot(jnp.asarray(idx), 4))
    got = tstructs.one_hot(torch.from_numpy(idx).long(), 4).numpy()
    np.testing.assert_array_equal(got, want)


def test_problem_and_state_numpy_roundtrip():
    jp = jscen.mesh()
    js = j_structured_init(jp)
    tp, ts = to_torch_problem(jp), to_torch_state(js)
    back = tstructs.Problem.from_numpy(tp.to_numpy(), hop_bound=tp.hop_bound, device="cpu")
    for k, v in tp.to_numpy().items():
        np.testing.assert_array_equal(v, back.to_numpy()[k])
    assert back.apps.src.dtype == torch.int64
    arrs = ts.to_numpy()
    np.testing.assert_array_equal(arrs["phi"], np.asarray(js.phi))
    np.testing.assert_array_equal(arrs["x"], np.asarray(js.x))


def test_hop_bound_matches_jax_inference():
    jp = jscen.random_connected(48, 6, seed=5)
    tp = to_torch_problem(jp)
    assert tstructs.infer_hop_bound(tp.net) == jstructs.infer_hop_bound(jp.net)
