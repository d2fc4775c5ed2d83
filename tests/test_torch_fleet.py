"""The port's fleet path against the JAX package's, on the CPU: the
networkx copies, the generator and the padding bitwise; `solve_fleet` for
the four methods, chunking, warm starts and its guards; and the fleet CLI's
JSON."""
import dataclasses
import importlib.util
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import problem_arrays, to_torch_problem
from repro import core as J
from repro import fleet as JF
from repro.fleet import solve as j_solve
from repro.launch import fleet as j_cli
from repro_torch import core as T
from repro_torch import fleet as TF
from repro_torch.core import _graphs
from repro_torch.fleet import solve as t_solve
from repro_torch.launch import fleet as t_cli

jax.config.update("jax_enable_x64", False)

HAS_NX = importlib.util.find_spec("networkx") is not None
SEEDS = range(6)
# A mixed fleet whose envelope stays small (V = 25, A = 30): two instances
# of each family, split depths 1, 2 and 3.
FLEET_KW = dict(seed=4, partitions=(1, 2, 3))
SOLVE_KW = dict(m_max=3, t_phi=3)


def _assert_arrays_equal(jax_problem, port_problem):
    want, got = problem_arrays(jax_problem), port_problem.to_numpy()
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k


# ---------------------------------------------------------------------------
# The networkx copies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", ["gnp", "gnp_complete", "barabasi_albert", "double_edge_swap",
                                  "watts_strogatz"])
def test_graph_copies_match_networkx(case, seed):
    if not HAS_NX:
        pytest.skip("networkx is not installed: nothing to compare the copies with")
    import networkx as nx

    if case == "gnp":
        want, got = nx.gnp_random_graph(26, 0.16, seed=seed), _graphs.gnp_random_graph(26, 0.16, seed=seed)
        assert nx.is_connected(want) == _graphs.is_connected(got)
    elif case == "gnp_complete":
        want, got = nx.gnp_random_graph(6, 1.0, seed=seed), _graphs.gnp_random_graph(6, 1.0, seed=seed)
    elif case == "barabasi_albert":
        want = nx.barabasi_albert_graph(24 + seed, 1 + seed % 3, seed=seed)
        got = _graphs.barabasi_albert_graph(24 + seed, 1 + seed % 3, seed=seed)
        assert list(want.degree()) == _graphs.degree(got)
    elif case == "double_edge_swap":
        # 5 and 21 swaps: small windows (undone one by one) and large ones
        # (undone in reverse), from GEANT's first-appearance node order.
        want, got = nx.Graph(T.scenarios._GEANT_EDGES), _graphs.graph_from_edges(T.scenarios._GEANT_EDGES)
        nswap = 5 if seed % 2 else 21
        assert nx.connected_double_edge_swap(want, nswap, seed=seed + 13) == \
            _graphs.connected_double_edge_swap(got, nswap, seed=seed + 13)
        assert list(want.degree()) == _graphs.degree(got)
    else:
        want = nx.connected_watts_strogatz_graph(30, 4, 0.3, seed=seed)
        got = _graphs.connected_watts_strogatz_graph(30, 4, 0.3, seed=seed)
    assert list(want.edges()) == _graphs.edges(got)


# ---------------------------------------------------------------------------
# Generator and padding, bitwise
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fleets():
    return JF.sample_fleet(8, **FLEET_KW), TF.sample_fleet(8, device="cpu", **FLEET_KW)


@pytest.mark.parametrize("families", [None] + [[f] for f in JF.FAMILIES],
                         ids=lambda f: "mixed" if f is None else f[0])
def test_sample_fleet_bitwise(families):
    kw = dict(seed=0, partitions=(1, 2, 3), families=families)
    want, got = JF.sample_fleet(8 if families is None else 3, **kw), TF.sample_fleet(
        8 if families is None else 3, device="cpu", **kw)
    for a, b in zip(want, got, strict=True):
        _assert_arrays_equal(a, b)
        assert a.hop_bound == b.hop_bound


def test_grids_bitwise():
    for a, b in zip(JF.load_grid(JF.iot_hierarchy, [0.5, 1.2], seed=3),
                    TF.load_grid(TF.iot_hierarchy, [0.5, 1.2], seed=3, device="cpu"), strict=True):
        _assert_arrays_equal(a, b)
    for a, b in zip(JF.eta_grid(J.geant, [0.2, 0.8]), TF.eta_grid(T.geant, [0.2, 0.8], device="cpu"),
                    strict=True):
        _assert_arrays_equal(a, b)
    with pytest.raises(ValueError, match="unknown families"):
        TF.sample_fleet(2, families=["torus"], device="cpu")
    with pytest.raises(ValueError, match="partitions"):
        TF.sample_fleet(2, partitions=(0,), device="cpu")


def test_padding_bitwise(fleets):
    jf, tf = fleets
    a, b = jf[2], tf[2]
    pa, ia = JF.pad_problem(a, 40, 44, 4)
    pb, ib = TF.pad_problem(b, 40, 44, 4)
    _assert_arrays_equal(pa, pb)
    assert np.array_equal(np.asarray(ia.node_mask), ib.node_mask.numpy())
    assert np.array_equal(np.asarray(ia.app_mask), ib.app_mask.numpy())
    assert ib.n_real_nodes == a.net.n_nodes and ib.n_real_apps == a.apps.n_apps
    _assert_arrays_equal(JF.pad_problem_parts(a, 4), TF.pad_problem_parts(b, 4))
    for kw in (dict(round_to=8), dict(envelope=(32, 40), n_parts=4, hop_bound=30), {}):
        js, ji = JF.stack_problems(jf, **kw)
        ts, ti = TF.stack_problems(tf, **kw)
        _assert_arrays_equal(js, ts)
        assert js.hop_bound == ts.hop_bound
        assert np.array_equal(np.asarray(ji.node_mask), ti.node_mask.numpy())
    assert TF.fleet_envelope(tf, round_to=8) == JF.fleet_envelope(jf, round_to=8)
    assert TF.fleet_part_envelope(tf) == JF.fleet_part_envelope(jf) == 3
    with pytest.raises(ValueError, match="down to"):
        TF.pad_problem(b, 4, 44)


def test_padded_j_equals_unpadded(fleets):
    """Pad nodes, pad apps and phantom stages are inert: the same J."""
    _, tf = fleets
    p = tf[1]
    padded, _ = TF.pad_problem(p, p.net.n_nodes + 5, p.apps.n_apps + 3, p.apps.n_parts + 2)
    want = T.solve_alt(p, device="cpu", **SOLVE_KW)
    got = T.solve_alt(padded, device="cpu", **SOLVE_KW)
    np.testing.assert_allclose(got.J, want.J, rtol=1e-5)
    assert got.iters == want.iters


# ---------------------------------------------------------------------------
# solve_fleet
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def solved(fleets):
    """Each method through both fleets, JAX jitted once per method."""
    jf, tf = fleets
    return {
        m: (JF.solve_fleet(jf, method=m, **SOLVE_KW), TF.solve_fleet(tf, method=m, device="cpu", **SOLVE_KW))
        for m in TF.METHODS
    }


@pytest.mark.parametrize("method", TF.METHODS)
def test_solve_fleet_matches_jax(solved, method):
    want, got = solved[method]
    np.testing.assert_allclose(got.J, want.J, rtol=1e-5)
    np.testing.assert_allclose(got.J_comm, want.J_comm, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.J_comp, want.J_comp, rtol=1e-5, atol=1e-6)
    assert np.array_equal(got.iters, want.iters) and got.rounds == want.rounds
    assert got.m_max == want.m_max and np.array_equal(got.hosts, want.hosts)
    for k in ("parts", "node_mask", "app_mask"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert np.array_equal(np.isnan(got.history), np.isnan(want.history))
    assert (got.trace is None) == (want.trace is None)
    if got.trace is not None:
        assert got.trace.to_dict()["best_round"] == want.trace.to_dict()["best_round"]
        np.testing.assert_allclose(got.trace.J_comm, want.trace.J_comm, rtol=1e-5)
        assert np.array_equal(np.nan_to_num(got.trace.moves), np.nan_to_num(want.trace.moves))
    assert [r["hosts"] for r in got.per_instance()] == [r["hosts"] for r in want.per_instance()]
    assert got.summary().split("J:")[0] == want.summary().split("J:")[0]
    assert dataclasses.asdict(got.shard) == dataclasses.asdict(want.shard)


def test_solve_fleet_matches_sequential(fleets, solved):
    """The fleet's J per lane against `solve_sequential` on the unpadded
    instances (the engine at B = 1)."""
    _, tf = fleets
    seq = TF.solve_sequential(tf[:4], method="ALT", device="cpu", **SOLVE_KW)
    np.testing.assert_allclose([r.J for r in seq], solved["ALT"][1].J[:4], rtol=1e-5)
    with pytest.raises(TypeError, match="unknown solver kwargs"):
        TF.solve_sequential(tf[:1], device="cpu", m_maxx=2)


def test_chunked_solve(fleets, solved):
    """Chunks of 3 over 8 instances (the tail padded with repeats of its
    first instance, trimmed on gather) give the single batch's J."""
    _, tf = fleets
    got = TF.solve_fleet(tf, chunk_size=3, device="cpu", **SOLVE_KW)
    want = solved["ALT"][1]
    np.testing.assert_allclose(got.J, want.J, rtol=1e-5)
    assert np.array_equal(got.iters, want.iters) and got.shard.padded_batch == 9
    assert got.trace.live.shape == want.trace.live.shape


def test_envelope_cap_chunk(fleets):
    jf, tf = fleets
    for cap in (1e-4, 0.01, 0.5, 8.0):
        for n_dev in (1, 4):
            want = j_solve.envelope_cap_chunk(jf, round_to=8, n_devices=n_dev, cap_gb=cap)
            assert t_solve.envelope_cap_chunk(tf, round_to=8, n_devices=n_dev, cap_gb=cap) == want
    with pytest.raises(ValueError, match="positive"):
        t_solve.envelope_cap_chunk(tf, round_to=1, n_devices=1, cap_gb=0.0)
    capped = TF.solve_fleet(tf[:3], envelope_cap_gb=1e-4, device="cpu", m_max=1, t_phi=1)
    assert capped.shard.padded_batch == 3 and capped.n_instances == 3


def test_warm_start(fleets):
    """keep_state hands back the warm-start currency; a warm re-solve with
    lane 1 frozen returns that lane's warm evaluation, and its other lanes
    match JAX's warm re-solve."""
    jf, tf = fleets
    cold = TF.solve_fleet(tf[:3], keep_state=True, device="cpu", **SOLVE_KW)
    assert cold.state.x.shape[0] == 3
    mask = np.array([True, False, True])
    warm = TF.solve_fleet(tf[:3], warm_start=cold.state, warm_active=mask, device="cpu", **SOLVE_KW)
    assert warm.iters[1] == 0 and warm.J[1] == warm.history[1, 0]
    np.testing.assert_allclose(warm.history[:, 0], cold.J, rtol=1e-5)
    j_cold = JF.solve_fleet(jf[:3], keep_state=True, **SOLVE_KW)
    j_warm = JF.solve_fleet(jf[:3], warm_start=j_cold.state, warm_active=mask, **SOLVE_KW)
    np.testing.assert_allclose(warm.J, j_warm.J, rtol=1e-5)
    with pytest.raises(ValueError, match="envelope"):
        TF.solve_fleet(tf[:3] + [T.random_connected(40, 4, device="cpu")], warm_start=cold.state,
                       device="cpu", **SOLVE_KW)
    with pytest.raises(ValueError, match="single-chunk"):
        TF.solve_fleet(tf[:3], warm_start=cold.state, chunk_size=2, device="cpu", **SOLVE_KW)
    with pytest.raises(ValueError, match="requires warm_start"):
        TF.solve_fleet(tf[:3], warm_active=mask, device="cpu")
    with pytest.raises(ValueError, match="CongUnaware"):
        TF.solve_fleet(tf[:3], method="CongUnaware", warm_start=cold.state, device="cpu")
    with pytest.raises(ValueError, match="keep_state"):
        TF.solve_fleet(tf[:3], method="CongUnaware", keep_state=True, device="cpu")


def test_empty_fleet_errors():
    p = T.iot(device="cpu")
    dead = dataclasses.replace(p, net=dataclasses.replace(p.net, nu=torch.full_like(p.net.nu, TF.NU_PAD)))
    with pytest.raises(TF.EmptyFleetError):
        TF.stack_problems([])
    with pytest.raises(TF.EmptyFleetError):
        TF.pad_batch_to_multiple([], 2)
    with pytest.raises(TF.EmptyFleetError, match="dead"):
        TF.pad_batch_to_multiple([dead], 2)
    with pytest.raises(TF.EmptyFleetError):
        TF.solve_fleet([], device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        TF.pad_batch_to_multiple([p], 0)
    ext, n = TF.pad_batch_to_multiple([p, p, p], 2)
    assert n == 3 and len(ext) == 4 and ext[3] is p
    with pytest.raises(ValueError, match="mixes cost kinds"):
        TF.stack_problems([p, dataclasses.replace(p, cost=T.CostModel(kind="linear"))])


@pytest.mark.parametrize("fault", ["nan_mu", "neg_lam", "zero_nu", "all_dead", "dead_src"])
def test_validate_problems(fault):
    """The port rejects what JAX rejects, with the same message."""
    jp = J.iot()
    arrays = {k: v.copy() for k, v in problem_arrays(jp).items()}
    if fault == "nan_mu":
        arrays["net.mu"][0, 1] = np.nan
    elif fault == "neg_lam":
        arrays["apps.lam"][3] = -1.0
    elif fault == "zero_nu":
        arrays["net.nu"][2] = 0.0
    elif fault == "all_dead":
        arrays["net.nu"][:] = JF.NU_PAD
    else:
        arrays["net.nu"][int(arrays["apps.src"][0])] = JF.NU_PAD
    tp = T.Problem.from_numpy(arrays, hop_bound=jp.hop_bound, device="cpu")
    bad = dataclasses.replace(  # the same arrays on the JAX side
        jp, net=J.Network(**{k: jnp.asarray(arrays["net." + k]) for k in ("adj", "mu", "nu")}),
        apps=dataclasses.replace(jp.apps, lam=jnp.asarray(arrays["apps.lam"])),
    )
    with pytest.raises(ValueError) as want:
        j_solve._validate_problems([jp, bad])
    with pytest.raises(ValueError) as got:
        t_solve._validate_problems([to_torch_problem(jp), tp])
    assert str(got.value) == str(want.value)


def test_shard_plan(fleets, caplog, monkeypatch):
    _, tf = fleets
    with caplog.at_level(logging.WARNING, logger="repro_torch.fleet"):
        res = TF.solve_fleet(tf[:2], shard=True, device="cpu", m_max=1, t_phi=1)
    assert res.shard.reason == "single-device" and res.shard.n_devices == 1 and not res.shard.sharded
    assert "reason=single-device" in caplog.text
    assert "1dev B=2->2 single-device" in res.summary()
    with pytest.raises(ValueError, match="devices= only applies"):
        TF.solve_fleet(tf[:2], devices=2, device="cpu")
    # One process is a world of one rank, however many GPUs it sees: a
    # wider mesh needs one process a device (tests/test_torch_mesh.py).
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="process group has 1 rank"):
        t_solve._plan_mesh(True, 2, torch.device("cuda"))
    assert t_solve._plan_mesh(True, None, torch.device("cuda")) == (None, 1, "single-device")
    assert t_solve._plan_mesh(True, 1, torch.device("cuda")) == (None, 1, "single-device")
    assert t_solve._plan_mesh(False, None, torch.device("cuda")) == (None, 1, "not-requested")


def test_make_fleet_mesh_needs_a_process_group():
    """Without a process group one process is a world of one rank: a wider
    mesh is refused by its count, and even a one-rank mesh raises rather
    than start a group of its own."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_fleet_mesh

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group has 1 rank"):
        make_fleet_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="needs an initialised process group"):
        make_fleet_mesh(device="cpu")
    assert not dist.is_initialized()


def test_fleet_metrics(fleets):
    from repro_torch.obs import metrics

    _, tf = fleets
    metrics.registry.reset()
    TF.solve_fleet(tf[:5], chunk_size=2, device="cpu", m_max=1, t_phi=1)
    snap = metrics.registry.snapshot()
    assert snap["fleet.chunks_executed"] == 3 and snap["fleet.m_max"] == 1
    assert snap["fleet.pad_overhead_fraction"] == pytest.approx(1 / 6)
    assert snap["fleet.rounds_executed"] == 1 and snap["fleet.early_exit_saved_rounds"] == 0
    assert not any(k.startswith("fleet.compile") for k in snap)  # nothing compiles per shape


def test_cli_json_keys_match_jax(capsys):
    argv = ["--families", "erdos_renyi,iot_hierarchy", "--instances", "2", "--m-max", "2",
            "--t-phi", "2", "--partitions", "1,2"]
    assert j_cli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys()
    assert got["per_instance"][0].keys() == want["per_instance"][0].keys()
    assert got["trace"].keys() == want["trace"].keys()
    assert got["shard"] == want["shard"] and got["partition_mix"] == want["partition_mix"]
    np.testing.assert_allclose([r["J"] for r in got["per_instance"]],
                               [r["J"] for r in want["per_instance"]], rtol=1e-5)
    assert got["use_pallas"] is False and got["interpret"] is False


# ---------------------------------------------------------------------------
# Spans and the host-sync count (obs/sync.py)
# ---------------------------------------------------------------------------
def _traced_solve(problems, **kw):
    """`solve_fleet` with tracing on: (result, spans, host syncs counted)."""
    from repro_torch.obs import sync, trace

    trace.configure(enabled=True)
    trace.reset()
    first = sync.host_syncs()
    try:
        res = TF.solve_fleet(problems, device="cpu", **kw)
        return res, trace.TRACER.events(), sync.host_syncs() - first
    finally:
        trace.configure(enabled=False)
        trace.reset()


def test_tracing_changes_no_bit_and_untraced_counts(fleets):
    """With tracing on and off: J, hosts, x and phi bitwise equal; off,
    nothing is recorded and the counter still counts every sync."""
    from repro_torch.obs import sync, trace

    _, tf = fleets
    kw = dict(SOLVE_KW, keep_state=True)
    on, spans, counted = _traced_solve(tf[:3], **kw)
    first = sync.host_syncs()
    off = TF.solve_fleet(tf[:3], device="cpu", **kw)
    assert trace.TRACER.events() == [] and not trace.tracer_enabled()
    assert sync.host_syncs() - first == counted > 0
    for k in ("J", "J_comm", "J_comp", "hosts", "history", "iters"):
        assert np.array_equal(getattr(on, k), getattr(off, k), equal_nan=True), k
    assert torch.equal(on.state.x, off.state.x) and torch.equal(on.state.phi, off.state.phi)
    call = [e for e in spans if e.name == "solve_fleet.call"]
    assert len(call) == 1 and call[0].attrs["host_syncs"] == counted


def test_host_syncs_are_the_reads_at_their_sites(fleets, monkeypatch):
    """Each round's `host_syncs` is its min-plus closure's early-exit tests
    plus the exit-flag read that ends it; the call's adds eight copies a
    validated instance, the stack's three cost scalars copied to the
    device, the closure and exit flag before the first round and the
    gather's copies. Counted here at the sites themselves."""
    from repro_torch.core import engine
    from repro_torch.kernels.minplus import ops as mp_ops

    _, tf = fleets
    events = []

    def tap(name, fn):
        def wrapped(*a, **k):
            events.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(mp_ops, "minplus_matmul", tap("test", mp_ops.minplus_matmul))
    monkeypatch.setattr(engine, "_any_active", tap("flag", engine._any_active))
    monkeypatch.setattr(engine, "round_step", tap("round", engine.round_step))
    monkeypatch.setattr(torch.Tensor, "cpu", tap("copy", torch.Tensor.cpu))
    monkeypatch.setattr(torch, "tensor", tap("scalar", torch.tensor))
    res, spans, counted = _traced_solve(tf[:3], **SOLVE_KW)
    segments = " ".join(events).split("round")
    assert len(segments) == res.rounds + 1
    assert segments[0].split().count("copy") == 8 * 3  # the validation, before any product
    assert segments[0].split().count("scalar") == 3
    rounds = sorted((e for e in spans if e.name == "solve_fleet.round"), key=lambda e: e.attrs["m"])
    for r, seg in zip(rounds, segments[1:]):
        assert r.attrs["host_syncs"] == seg.split().count("test") + seg.split().count("flag")
    call = next(e for e in spans if e.name == "solve_fleet.call")
    assert call.attrs["host_syncs"] == counted == len(events) - res.rounds
