"""The port's fault-injection control plane against the JAX package's, on
the CPU: fault traces event for event, `apply_health` and the hop-bound
closures bitwise, the zero-load APSP cache and the fleet repair bitwise
against the JAX kernel path (squaring and the fused argmin, the algorithm
the port runs on both devices), the epoch controller epoch for epoch with
J at rtol 1e-5, the pinned hop bound on a stretched ring, and the control
CLI's JSON and span trace."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import problem_arrays, to_torch_state
from repro import chaos as JC
from repro import fleet as JF
from repro.core import scenarios as jsc
from repro.core import structs as jstructs
from repro.launch import control as j_cli
from repro.obs import metrics as j_metrics
from repro_torch import chaos as TC
from repro_torch import fleet as TF
from repro_torch.core import scenarios as tsc
from repro_torch.core import structs as tstructs
from repro_torch.launch import control as t_cli
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import validate

jax.config.update("jax_enable_x64", False)

IOT_KW = dict(families=["iot_hierarchy"], seed=0)
MIXED_KW = dict(seed=4, partitions=(1, 2, 3))
CONTROL_KW = dict(m_max=4, t_phi=4)


@pytest.fixture(scope="module")
def fleets():
    return {
        "iot": (JF.sample_fleet(4, **IOT_KW), TF.sample_fleet(4, device="cpu", **IOT_KW)),
        "mixed": (JF.sample_fleet(4, **MIXED_KW), TF.sample_fleet(4, device="cpu", **MIXED_KW)),
    }


def _env(jf):
    return dict(round_to=8, envelope=JF.fleet_envelope(jf, round_to=8), n_parts=JF.fleet_part_envelope(jf),
                hop_bound=JF.unify_hop_bound(jf))


def _perturbed(jf, tf, seed, epochs=10):
    """Per epoch: (JAX perturbed problems, port ones, JAX masks, port masks)."""
    out = []
    for (_, _, jh), (_, _, th) in zip(JC.generate_trace(jf, epochs, seed=seed).timeline(),
                                      TC.generate_trace(tf, epochs, seed=seed).timeline()):
        jp, jm = zip(*(JC.apply_health(p, h) for p, h in zip(jf, jh)))
        tp, tm = zip(*(TC.apply_health(p, h) for p, h in zip(tf, th)))
        out.append((list(jp), list(tp), list(jm), list(tm)))
    return out


# ---------------------------------------------------------------------------
# Traces and apply_health
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("which", ["iot", "mixed"])
def test_generate_trace_matches_jax(fleets, which, seed, tmp_path):
    jf, tf = fleets[which]
    kw = dict(node_failures=4, link_degradations=3, flash_crowds=2)
    want, got = JC.generate_trace(jf, 20, seed=seed, **kw), TC.generate_trace(tf, 20, seed=seed, **kw)
    assert got.to_json() == want.to_json()
    assert got.counts()["node_down"] == 4
    want.save(tmp_path / "want.json")
    got.save(tmp_path / "got.json")
    assert (tmp_path / "got.json").read_text() == (tmp_path / "want.json").read_text()
    for (e1, f1, h1), (e2, f2, h2) in zip(want.timeline(), got.timeline(), strict=True):
        assert e1 == e2 and [ev.to_dict() for ev in f1] == [ev.to_dict() for ev in f2]
        assert [dataclasses.astuple(h) for h in h1] == [dataclasses.astuple(h) for h in h2]


def test_trace_errors_match_jax(fleets):
    jf, tf = fleets["iot"]
    for args, kw in (((jf, 3), {}), (([], 10), {}), ((jf, 10), {"node_failures": 400})):
        targs = (tf if args[0] is jf else [],) + args[1:]
        with pytest.raises(ValueError) as want:
            JC.generate_trace(*args, **kw)
        with pytest.raises(ValueError) as got:
            TC.generate_trace(*targs, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown event kind"):
        TC.FaultEvent(0, "meteor", 0)
    assert TC.InstanceHealth().pristine and not TC.InstanceHealth(rate_scale=2.0).pristine


def test_apply_health_bitwise(fleets):
    """Every instance of every epoch of a trace with node churn, link
    degradation and a flash crowd: the perturbed arrays and live masks
    bitwise the JAX package's; a pristine instance comes back as is."""
    jf, tf = fleets["mixed"]
    kinds = set()
    for jp, tp, jm, tm in _perturbed(jf, tf, seed=5):
        for a, b, ma, mb in zip(jp, tp, jm, tm):
            want, got = problem_arrays(a), b.to_numpy()
            for k in want:
                assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k
            assert ma.dtype == mb.dtype and np.array_equal(ma, mb)
            assert a.hop_bound == b.hop_bound
            kinds.add("down" if (mb == 0).any() else "up")
    assert kinds == {"down", "up"}
    same, live = TC.apply_health(tf[0], TC.InstanceHealth())
    assert same is tf[0] and live.all()


# ---------------------------------------------------------------------------
# The hop-bound closure
# ---------------------------------------------------------------------------
def test_hop_bound_cache_matches_jax():
    """Kills and restores on smallworld (V = 30): the warm refresh is bitwise
    the cold closure and JAX's, with JAX's bound and sweep count (-1 cold,
    0 unchanged adjacency, else the squarings taken)."""
    jp, tp = jsc.smallworld(), tsc.smallworld(device="cpu")
    adj = np.asarray(jp.net.adj)
    ends = JC.events._protected_nodes(jp)
    kill = [v for v in range(adj.shape[0]) if v not in ends and JC.events._connected_without(adj, {v})][:3]
    steps = [frozenset(), frozenset(kill[:1]), frozenset(kill[:2]), frozenset(kill[:2]),
             frozenset(kill[1:3]), frozenset()]
    jc = tc = None
    sweeps = []
    for down in steps:
        health = JC.InstanceHealth(down=down)
        ja, _ = JC.apply_health(jp, health)
        ta, _ = TC.apply_health(tp, TC.InstanceHealth(down=down))
        jc = jstructs.hop_bound_cache(ja.net, jc)
        tc = tstructs.hop_bound_cache(ta.net, tc, device="cpu")
        cold = tstructs.hop_bound_cache(ta.net, None, device="cpu")
        assert torch.equal(tc.dist, cold.dist) and tc.hop_bound == cold.hop_bound
        assert np.array_equal(tc.dist.numpy(), jc.dist)
        assert (tc.hop_bound, tc.sweeps) == (jc.hop_bound, jc.sweeps)
        assert tstructs.infer_hop_bound(ta.net, tc) == tc.hop_bound
        sweeps.append(tc.sweeps)
    assert sweeps[0] == -1 and sweeps[3] == 0 and max(sweeps) >= 1
    bare = dataclasses.replace(tp, hop_bound=None)
    assert tstructs.with_hop_bound(bare, tc).hop_bound == tc.hop_bound == jc.hop_bound


# ---------------------------------------------------------------------------
# Zero-load APSP cache and fleet repair
# ---------------------------------------------------------------------------
def test_refresh_apsp0_matches_jax(fleets):
    """Over a trace, each epoch's cache: dist and next hops bitwise JAX's,
    the same hits and misses, and a hit hands back the very tensors."""
    jf, tf = fleets["mixed"]
    env = _env(jf)
    jc = tc = None
    for jp, tp, _, _ in _perturbed(jf, tf, seed=5):
        prev = tc
        jc = JC.refresh_apsp0(jp, jc, use_pallas=True, interpret=True, **env)
        tc = TC.refresh_apsp0(tp, tc, device="cpu", **env)
        assert np.array_equal(tc.dist.numpy(), jc.dist)
        assert np.array_equal(tc.nexthop.numpy(), jc.nexthop)
        assert (tc.reused, tc.hits, tc.misses) == (jc.reused, jc.hits, jc.misses)
        if tc.reused:
            assert tc is prev and tc.sp()[0] is prev.dist
    assert tc.hits > 0 and tc.misses > 1


def test_repair_fleet(fleets):
    """From the same solved state: all-live masks give it back bitwise; two
    dead nodes hosting partitions are evicted to JAX's hosts."""
    jf, tf = fleets["mixed"]
    env = _env(jf)
    j_res = JF.solve_fleet(jf, keep_state=True, m_max=2, t_phi=2, round_to=8)
    state = to_torch_state(j_res.state)
    ones = [np.ones(p.net.n_nodes, np.float32) for p in tf]
    same = TC.repair_fleet(tf, state, ones, device="cpu", **env)
    assert torch.equal(same.x, state.x) and torch.equal(same.phi, state.phi)
    with pytest.raises(ValueError, match="envelope"):
        TC.repair_fleet(tf, state, ones, device="cpu", round_to=8, envelope=(40, 40), n_parts=3)

    # On each instance, kill up to two busy nodes whose loss keeps it servable.
    healths = []
    for b, p in enumerate(jf):
        adj = np.asarray(p.net.adj)
        busy = sorted({int(h) for a in range(p.apps.n_apps)
                       for h in j_res.hosts[b, a, :int(np.asarray(p.apps.parts)[a])]})
        ends, dead = JC.events._protected_nodes(p), set()
        for v in busy:
            if v not in ends and len(dead) < 2 and JC.events._connected_without(adj, dead | {v}):
                dead.add(v)
        healths.append(frozenset(dead))
    assert sum(map(len, healths)) >= 2
    jp, jm = zip(*(JC.apply_health(p, JC.InstanceHealth(down=d)) for p, d in zip(jf, healths)))
    tp, tm = zip(*(TC.apply_health(p, TC.InstanceHealth(down=d)) for p, d in zip(tf, healths)))
    want = JC.repair_fleet(list(jp), j_res.state, list(jm), use_pallas=True, interpret=True, **env)
    apsp0 = TC.refresh_apsp0(list(tp), None, device="cpu", **env)
    for sp in (None, apsp0):
        got = TC.repair_fleet(list(tp), state, list(tm), apsp0=sp, device="cpu", **env)
        assert np.array_equal(got.hosts().numpy(), np.asarray(want.hosts()))
        assert np.array_equal(got.phi.numpy(), np.asarray(want.phi))
    hosts = got.hosts().numpy()
    for b, (p, dead) in enumerate(zip(tf, healths)):
        for a, pa in enumerate(p.apps.parts.tolist()):
            assert not set(hosts[b, a, :pa].tolist()) & dead
    assert t_cli._feasible_hosts(hosts, [p.apps.parts.numpy() for p in tf], tm)
    assert not t_cli._feasible_hosts(j_res.hosts, [p.apps.parts.numpy() for p in tf], tm)


# ---------------------------------------------------------------------------
# The epoch controller
# ---------------------------------------------------------------------------
_SAME_KEYS = ("epoch", "mode", "outcome", "attempts", "perturbed", "events", "rounds", "finite",
              "feasible", "cold_rounds")


def _assert_reports_match(want, got):
    assert len(want.reports) == len(got.reports)
    for a, b in zip(want.reports, got.reports):
        da, db = a.to_dict(), b.to_dict()
        assert da.keys() == db.keys()
        assert {k: da[k] for k in _SAME_KEYS} == {k: db[k] for k in _SAME_KEYS}, da["epoch"]
        assert (da["recovery_s"] is None) == (db["recovery_s"] is None)
        np.testing.assert_allclose(db["J_median"], da["J_median"], rtol=1e-5)


def _control_counters(reg):
    return {k: v for k, v in reg.snapshot().items()
            if k.startswith("control.") and k != "control.recovery_latency_s"}


def test_run_control_matches_jax(fleets):
    """4 iot_hierarchy instances over 8 epochs with both verifications on:
    every epoch's report is JAX's (J at rtol 1e-5), and so are the
    control.* counters and gauges."""
    jf, tf = fleets["iot"]
    kw = dict(CONTROL_KW, epochs=8, seed=1, verify_hop_bound=True, verify_apsp0=True)
    j_metrics.registry.reset()
    want = j_cli.run_control(jf, **kw)
    t_metrics.registry.reset()
    got = t_cli.run_control(tf, device="cpu", **kw)
    _assert_reports_match(want, got)
    assert _control_counters(t_metrics.registry) == _control_counters(j_metrics.registry)
    snap = t_metrics.registry.snapshot()
    assert snap["control.apsp0.hits"] > 0 and snap["control.hop_bound.warm_sweeps"] > 0
    s_want, s_got = want.summary(), got.summary()
    for k in s_want:
        if k not in ("epochs_per_s", "wall_s", "p50_recovery_latency_s", "p95_recovery_latency_s"):
            assert s_got[k] == s_want[k], k
    assert s_got.keys() == s_want.keys()
    with pytest.raises(ValueError, match="trace= or epochs="):
        t_cli.run_control(tf, device="cpu")
    with pytest.raises(ValueError, match="covers 4 instances"):
        t_cli.run_control(tf[:2], trace=TC.generate_trace(tf, 8, seed=1), device="cpu")


def _ring(sc, n, **kw):
    """An n-node ring with unit rates, three single-partition apps from node
    1 to node n - 1 (the far side of node 0)."""
    rng = np.random.RandomState(0)
    net = sc.build_network(n, [(i, (i + 1) % n) for i in range(n)], {}, np.full(n, 10.0, np.float32), **kw)
    apps = sc.gen_apps(rng, 3, np.array([1]), "random", n, n_parts=1, **kw)
    apps = dataclasses.replace(apps, dst=apps.dst * 0 + (n - 1))
    return apps, net


def test_pinned_hop_bound_stretched_ring():
    """Killing node 0 of an 80-node ring stretches the route from node 1 to
    node 79 from 2 hops to 78, past the pinned bound (diameter 40 + 2) plus
    the Neumann kernel's 32-hop slack; the JAX package's XLA path floors
    its cap at V + 1. The port solves such epochs, and the rest of the run
    (the restored ring starts warm from the stretched routes), under the
    highest tracked bound: every epoch's J matches JAX's."""
    ja, jn = _ring(jsc, 80)
    ta, tn = _ring(tsc, 80, device="cpu")
    jp = jstructs.with_hop_bound(jstructs.Problem(net=jn, apps=ja, cost=jstructs.CostModel()))
    tp = tstructs.with_hop_bound(tstructs.Problem(net=tn, apps=ta, cost=tstructs.CostModel()))
    assert jp.hop_bound == tp.hop_bound == 42
    events = [(1, JC.NODE_DOWN), (4, JC.NODE_UP)]
    jt = JC.FaultTrace(tuple(JC.FaultEvent(e, k, 0, node=0) for e, k in events), 6, 1)
    tt = TC.FaultTrace(tuple(TC.FaultEvent(e, k, 0, node=0) for e, k in events), 6, 1)
    kw = dict(m_max=3, t_phi=3, verify_hop_bound=True)
    j_metrics.registry.reset()
    want = j_cli.run_control([jp], trace=jt, **kw)
    t_metrics.registry.reset()
    got = t_cli.run_control([tp], trace=tt, device="cpu", **kw)
    assert t_metrics.registry.snapshot()["control.hop_bound.exceeds_pinned"] == 3
    assert _control_counters(t_metrics.registry) == _control_counters(j_metrics.registry)
    _assert_reports_match(want, got)


def test_cli_json_and_trace(tmp_path, capsys):
    """The control CLI's JSON keys, fault trace, and each epoch's outcome,
    rounds and cold-comparison rounds are the JAX CLI's, and its span trace
    validates."""
    argv = ["--instances", "2", "--epochs", "5", "--m-max", "2", "--t-phi", "2", "--assert-feasible",
            "--verify-hop-bound", "--verify-apsp0", "--compare-cold"]
    j_metrics.registry.reset()
    assert j_cli.main(argv + ["--events-out", str(tmp_path / "j.json")]) == 0
    want = json.loads(capsys.readouterr().out)
    t_metrics.registry.reset()
    trace_out = tmp_path / "spans.jsonl"
    assert t_cli.main(argv + ["--events-out", str(tmp_path / "t.json"), "--trace-out", str(trace_out),
                              "--json-out", str(tmp_path / "out.json"), "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys() and got["summary"].keys() == want["summary"].keys()
    assert got["epochs"][0].keys() == want["epochs"][0].keys()
    assert {k for k in got["metrics"] if k.startswith("control.")} == \
        {k for k in want["metrics"] if k.startswith("control.")}
    for key in ("outcome", "rounds", "cold_rounds"):
        assert [e[key] for e in got["epochs"]] == [e[key] for e in want["epochs"]], key
    assert any(e["cold_rounds"] is not None for e in got["epochs"])
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert json.loads((tmp_path / "out.json").read_text())["summary"]["epochs"] == 5
    from repro_torch.obs import trace as obs_trace

    obs_trace.configure(enabled=False)
    n_events, errors = validate.validate_file(trace_out)
    assert not errors and n_events > 5 * 4
    names = {json.loads(ln)["name"] for ln in trace_out.read_text().splitlines()}
    assert {"control.epoch", "control.chaos", "control.hop_bound", "control.repair",
            "control.solve", "control.compare_cold", "launch.control.build"} <= names
    assert validate.main([str(trace_out)]) == 0
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"ts": 0, "name": "x", "dur": -1, "attrs": {}}\n')
    assert validate.main([str(bad)]) == 1
    capsys.readouterr()
