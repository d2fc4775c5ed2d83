"""The port's placement sweep, `repair_placement` and the engine's round
trace, on the CPU: the sweep's dispatch (CPU tensors run the plain scan),
the plain scan against the JAX package's scan, the port's one schedule
against the JAX package's blocked sweep at every block size (on the paper
topologies and on a padded mixed-depth fleet), failure repair against
JAX's, and the trace against JAX's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import to_jax_state, to_torch_problem
from repro import core as J
from repro import fleet as JF
from repro.core import engine as j_engine
from repro.core import placement as j_placement
from repro.fleet import pad as j_pad
from repro_torch import core as T
from repro_torch.core import _graphs
from repro_torch.core import placement as t_placement
from repro_torch.fleet import NU_PAD, sample_fleet, stack_problems
from repro_torch.kernels import _build
from repro_torch.kernels.minplus import apsp_with_nexthop
from repro_torch.kernels.placement import ops as sweep_ops
from repro_torch.kernels.placement import ref as sweep_ref

jax.config.update("jax_enable_x64", False)

NAMES = list(J.SCENARIOS)
MOVE_MARGIN = 0.02


@pytest.fixture(scope="module")
def sweep_inputs():
    """(JAX problem, port problem stacked at B=1, port state, ctg) per
    topology and schedule: structured init plus two forwarding sweeps, so
    the sweep starts from congested marginals and moves hosts."""
    out = {}
    for name in NAMES:
        for colocate in (False, True):
            jp = J.SCENARIOS[name](n_parts=3) if name == "mesh" else J.SCENARIOS[name]()
            st = T.stack_single(to_torch_problem(jp))
            s0 = T.forwarding_update(st, T.structured_init(st, colocate=colocate), t_phi=2)
            _, aux = T.round_eval(st, s0)
            out[name, colocate] = (jp, st, s0, aux["ctg"])
    return out


def _sweep_operands(st, s0, ctg):
    """(hosts, dist, G, cprime) as `placement_update` hands them to a sweep."""
    dist, _ = apsp_with_nexthop(ctg[1])
    return s0.hosts(), dist, ctg[5], t_placement.comp_marginal(st)


@pytest.mark.parametrize("colocate", [False, True], ids=["chain", "colocated"])
@pytest.mark.parametrize("name", NAMES)
def test_sweep_dispatch_runs_plain_on_cpu(sweep_inputs, name, colocate, monkeypatch):
    """On CPU tensors `ops.placement_sweep` is `ref.sequential_sweep`,
    bitwise, and launches no kernel; `placement_update` commits its hosts."""
    _, st, s0, ctg = sweep_inputs[name, colocate]
    hosts, dist, G, cprime = _sweep_operands(st, s0, ctg)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    kw = dict(colocate=colocate, move_margin=MOVE_MARGIN)
    got = sweep_ops.placement_sweep(st, hosts, dist, G, cprime, **kw)
    want = sweep_ref.sequential_sweep(st, hosts, dist, G, cprime, **kw)
    assert torch.equal(got, want) and not any(_build.LAUNCHES.values())
    assert bool((want != hosts).any())
    assert torch.equal(T.placement_update(st, s0, ctg, **kw).hosts(), want)


@pytest.mark.parametrize("colocate", [False, True], ids=["chain", "colocated"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_sweep_matches_jax_scan(sweep_inputs, name, colocate):
    """The plain sequential scan against the JAX package's scan on the same
    state: hosts equal, or, on a placement near-tie, the swept states' J at
    rtol 1e-5."""
    jp, st, s0, ctg = sweep_inputs[name, colocate]
    hosts, dist, G, cprime = _sweep_operands(st, s0, ctg)
    got = sweep_ref.sequential_sweep(st, hosts, dist, G, cprime, colocate=colocate, move_margin=MOVE_MARGIN)
    want = J.placement_update(jp, to_jax_state(T.engine._squeeze(s0)), colocate=colocate)
    if not np.array_equal(got[0].numpy(), np.asarray(want.hosts())):
        swept = T.placement_update(st, s0, ctg, colocate=colocate)
        assert torch.equal(swept.hosts(), got)
        j_got, _ = T.round_eval(st, swept)
        j_want, _ = J.round_eval(jp, want)
        np.testing.assert_allclose(float(j_got[0]), float(j_want), rtol=1e-5)


def _assert_hosts_or_tie(st, got, lane, jp, want):
    """Lane `lane` of the port's swept state against the JAX package's: hosts
    equal, or, on a placement near-tie, the swept states' J at rtol 1e-5."""
    if not np.array_equal(got.hosts()[lane].numpy(), np.asarray(want.hosts())):
        j_got, _ = T.round_eval(st, got)
        j_want, _ = J.round_eval(jp, want)
        np.testing.assert_allclose(float(j_got[lane]), float(j_want), rtol=1e-5)


@pytest.mark.parametrize("bk", [1, 4, 0])
@pytest.mark.parametrize("colocate", [False, True], ids=["chain", "colocated"])
@pytest.mark.parametrize("name", NAMES)
def test_sweep_matches_jax_blocked(sweep_inputs, name, colocate, bk):
    """The port's one schedule, the sequential scan, against the JAX
    package's blocked sweep at block sizes 1, 4 and 0 (one block over every
    app) on the same state."""
    jp, st, s0, ctg = sweep_inputs[name, colocate]
    got = T.placement_update(st, s0, ctg, colocate=colocate)
    want = J.blocked_placement_update(jp, to_jax_state(T.engine._squeeze(s0)), colocate=colocate,
                                      block_apps=bk)
    _assert_hosts_or_tie(st, got, 0, jp, want)


@pytest.mark.parametrize("bk", [3, 0])
def test_sweep_matches_jax_blocked_mixed_p_fleet(bk):
    """A stacked mixed-depth fleet (phantom stages, pad nodes and pad apps
    at V = 31, not a multiple of 4): the port's sweep against the JAX
    package's blocked sweep, lane by lane on the JAX package's own stack of
    the same instances."""
    kw = dict(seed=0, partitions=(1, 2, 3))
    st, _ = stack_problems(sample_fleet(4, device="cpu", **kw))
    js, _ = JF.stack_problems(JF.sample_fleet(4, **kw))
    s0 = T.forwarding_update(st, T.structured_init(st), t_phi=2)
    _, aux = T.round_eval(st, s0)
    got = T.placement_update(st, s0, aux["ctg"])
    assert bool((got.hosts() != s0.hosts()).any())
    for lane in range(4):
        jl = jax.tree_util.tree_map(lambda v: v[lane], js)
        s_lane = T.State(x=s0.x[lane], phi=s0.phi[lane])
        want = J.blocked_placement_update(jl, to_jax_state(s_lane), block_apps=bk)
        _assert_hosts_or_tie(st, got, lane, jl, want)


# ---------------------------------------------------------------------------
# repair_placement
# ---------------------------------------------------------------------------
def _kill(problem, dead):
    """The pad encoding of dead nodes (adj rows and columns 0, mu BIG,
    nu NU_PAD), on a JAX problem, as the chaos layer applies it."""
    adj = np.array(problem.net.adj)
    mu = np.array(problem.net.mu)
    nu = np.array(problem.net.nu)
    for d in dead:
        adj[d, :] = adj[:, d] = 0.0
        mu[d, :] = mu[:, d] = J.BIG
        nu[d] = NU_PAD
    net = J.Network(adj=jnp.asarray(adj), mu=jnp.asarray(mu), nu=jnp.asarray(nu))
    live = np.ones(problem.net.n_nodes, np.float32)
    live[list(dead)] = 0.0
    return dataclasses.replace(problem, net=net), live


# Every node of mesh is an app endpoint: a random instance with few apps
# stands in for it.
REPAIR_CASES = {
    "iot": J.iot, "smallworld": J.smallworld, "geant": J.geant,
    "random_connected": lambda: J.random_connected(24, 8, seed=2),
}


@pytest.mark.parametrize("name", list(REPAIR_CASES))
def test_repair_placement_matches_jax(name):
    """Two busy non-endpoint nodes whose loss keeps the graph connected die:
    the port evicts to JAX's hosts, leaves nothing on the dead nodes and
    keeps every live host."""
    jp = REPAIR_CASES[name]()
    res = J.solve_alt(jp, m_max=2, t_phi=3)
    hosts = np.asarray(res.state.hosts())
    endpoints = set(np.asarray(jp.apps.src).tolist()) | set(np.asarray(jp.apps.dst).tolist())
    adj = np.asarray(jp.net.adj)
    dead = []
    for h in np.unique(hosts):
        alive = [u for u in range(jp.net.n_nodes) if u not in dead + [int(h)]]
        rest = _graphs.graph_from_edges(
            (u, v) for u in alive for v in alive if u < v and adj[u, v] > 0)
        if int(h) not in endpoints and len(rest) == len(alive) and _graphs.is_connected(rest):
            dead.append(int(h))
        if len(dead) == 2:
            break
    assert dead, name
    jd, live = _kill(jp, dead)
    want = np.asarray(j_placement.repair_placement(jd, res.state, jnp.asarray(live)).hosts())
    td = T.stack_single(to_torch_problem(jd))
    ts = T.stack_single(to_torch_problem(jp))
    t_state = T.State(x=torch.tensor(np.asarray(res.state.x))[None],
                      phi=torch.tensor(np.asarray(res.state.phi))[None])
    got = T.repair_placement(td, t_state, torch.from_numpy(live)[None])
    assert np.array_equal(got.hosts()[0].numpy(), want)
    assert not np.isin(got.hosts()[0].numpy(), dead).any()
    keep = ~np.isin(hosts, dead)
    assert np.array_equal(got.hosts()[0].numpy()[keep], hosts[keep])
    assert not keep.all(), name
    # All live: the state comes back bitwise.
    same = T.repair_placement(ts, t_state, torch.ones(1, jp.net.n_nodes))
    assert torch.equal(same.x, t_state.x) and torch.equal(same.phi, t_state.phi)
    # A precomputed zero-load APSP gives the same repair.
    sp = apsp_with_nexthop(T.zero_load_dp(td))
    again = T.repair_placement(td, t_state, torch.from_numpy(live)[None], sp=sp)
    assert torch.equal(again.x, got.x) and torch.equal(again.phi, got.phi)


# ---------------------------------------------------------------------------
# The round trace
# ---------------------------------------------------------------------------
TRACE_KW = dict(m_max=6, t_phi=3, alpha=0.5, tol=1e-3, patience=2)


@pytest.fixture(scope="module")
def traced():
    """Three instances of mixed size and depth, stacked, through both
    engines with trace=True (JAX jitted once)."""
    probs = [J.random_connected(14, 5, seed=0, n_parts=1), J.random_connected(18, 6, seed=1),
             J.geant(n_parts=3)]
    js, _ = j_pad.stack_problems(probs)
    ts, _ = stack_problems([to_torch_problem(p) for p in probs])
    want = jax.device_get(j_engine.engine_solve(js, trace=True, **TRACE_KW))
    got = T.engine_solve(ts, trace=True, device="cpu", **TRACE_KW)
    return ts, want, got


def test_trace_matches_jax(traced):
    _, want, got = traced
    np.testing.assert_allclose(got["J"].numpy(), want["J"], rtol=1e-5)
    assert np.array_equal(got["iters"].numpy(), want["iters"]) and got["rounds"] == int(want["rounds"])
    tw, tg = want["trace"], got["trace"]
    for k in ("J_comm", "J_comp"):
        g, w = getattr(tg, k).numpy(), np.asarray(getattr(tw, k))
        assert np.array_equal(np.isnan(g), np.isnan(w)), k
        np.testing.assert_allclose(g, w, rtol=1e-5)
    for k in ("moves", "live", "best_round"):
        g, w = getattr(tg, k).numpy(), np.asarray(getattr(tw, k))
        assert np.array_equal(np.isnan(g), np.isnan(w)) if g.dtype.kind == "f" else True, k
        assert np.array_equal(np.nan_to_num(g), np.nan_to_num(w)), k


def test_trace_freeze_contract(traced):
    """Past each lane's freeze point: NaN in J_comm / J_comp / moves, 0.0 in
    live; column 0 is the init (moves 0, live 1); best_round indexes the
    returned J in the history."""
    _, _, got = traced
    tr = got["trace"]
    for b in range(3):
        n = int(got["iters"][b])
        assert torch.equal(tr.live[b, : n + 1], torch.ones(n + 1))
        assert bool((tr.live[b, n + 1:] == 0.0).all())
        for buf in (tr.J_comm, tr.J_comp, tr.moves):
            assert not bool(buf[b, : n + 1].isnan().any())
            assert bool(buf[b, n + 1:].isnan().all())
        assert float(tr.moves[b, 0]) == 0.0
        assert float(got["history"][b, int(tr.best_round[b])]) == float(got["J"][b])


def test_trace_off_is_bitwise_the_same(traced):
    ts, _, got = traced
    off = T.engine_solve(ts, trace=False, device="cpu", **TRACE_KW)
    assert off["trace"] is None
    for k in ("J", "J_comm", "J_comp", "hosts", "iters"):
        assert torch.equal(off[k], got[k]), k
    assert torch.equal(off["history"].nan_to_num(), got["history"].nan_to_num())
    assert torch.equal(off["state"].phi, got["state"].phi)


@pytest.mark.parametrize("lane_chunk", [1, 2])
def test_lane_chunk_bitwise(traced, lane_chunk):
    """k-lane slices give the fused batch's per-lane outputs bitwise."""
    ts, _, got = traced
    out = T.engine_solve(ts, trace=True, lane_chunk=lane_chunk, device="cpu", **TRACE_KW)
    for k in ("J", "J_comm", "J_comp", "hosts", "iters"):
        assert torch.equal(out[k], got[k]), k
    assert out["rounds"] == got["rounds"]
    for k in ("J_comm", "moves", "live", "best_round"):
        assert torch.equal(getattr(out["trace"], k).nan_to_num(), getattr(got["trace"], k).nan_to_num()), k
    assert torch.equal(out["state"].phi, got["state"].phi)
    with pytest.raises(ValueError, match="lane_chunk"):
        T.engine_solve(ts, lane_chunk=-1, device="cpu", **TRACE_KW)


def test_placement_churn_masks_padding():
    st, _ = stack_problems([T.iot(device="cpu", n_parts=1), T.geant(device="cpu", n_parts=3)])
    s0 = T.structured_init(st)
    hosts = s0.hosts()
    moved = torch.remainder(hosts + 1, st.net.n_nodes)  # every host moves
    s1 = T.State(x=T.one_hot(moved, st.net.n_nodes), phi=s0.phi)
    churn = T.placement_churn(st, s1, s0)
    live = T.partition_live_mask(st.apps) * T.app_live_mask(st.apps)[..., None]
    assert torch.equal(churn, live.sum(dim=(-2, -1)))
    assert float(churn[0]) == 20.0  # iot: 20 apps of depth 1, padded to P = 3 and A = 30
