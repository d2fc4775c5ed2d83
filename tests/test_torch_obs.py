"""Port parity: the serve path's observability (repro_torch.obs) against the
JAX package's `obs/metrics.py` and `obs/trace.py`: the same operations give
the same snapshots, and the port's span files pass the JAX package's
validator."""
import json

import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro.obs import metrics as j_metrics
from repro.obs.validate import validate_lines
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import trace as t_trace


def _drive(reg, values):
    reg.counter("serve.requests").inc()
    reg.counter("serve.requests").inc(len(values))
    reg.gauge("serve.decode_tokens_per_s").set(float(values.sum()))
    h = reg.histogram("serve.latency_s")
    for v in values:
        h.observe(float(v))
    return reg.snapshot()


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (7, 2), (100, 3)])
def test_registry_snapshots_match_jax(n, seed):
    values = np.random.RandomState(seed).exponential(size=n)
    assert _drive(t_metrics.MetricsRegistry(), values) == _drive(j_metrics.MetricsRegistry(), values)


def test_registry_errors_match_jax():
    for mod in (t_metrics, j_metrics):
        reg = mod.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.gauge("x")
        assert mod.Histogram().snapshot() == {"count": 0}
        with pytest.raises(ValueError):
            mod.Histogram().percentile(50)
        reg.reset()
        assert reg.snapshot() == {}


def test_disabled_tracer_records_nothing():
    tr = t_trace.Tracer()
    with tr.span("serve.prefill", admitted=2):
        pass
    assert tr.events() == []


def test_spans_nest_and_validate_with_jax_validator(tmp_path):
    tr = t_trace.Tracer()
    tr.configure(enabled=True)
    with tr.span("serve.run", requests=2):
        with tr.span("serve.prefill", admitted=2):
            pass
        with tr.span("serve.decode", pos=4):
            pass
    ev = {e.name: e for e in tr.events()}
    assert ev["serve.prefill"].parent == ev["serve.run"].id and ev["serve.run"].parent == -1
    assert [e.name for e in tr.events()][-1] == "serve.run"  # recorded at exit
    path = tmp_path / "t.jsonl"
    tr.write_jsonl(path)
    records, errors = validate_lines(path.read_text().splitlines())
    assert errors == [] and len(records) == 3
    tr.write_chrome_trace(tmp_path / "t.trace.json")
    payload = json.loads((tmp_path / "t.trace.json").read_text())
    assert {e["name"] for e in payload["traceEvents"]} == set(ev) and payload["traceEvents"][0]["ph"] == "X"
    assert t_trace.chrome_path_for("a/b.jsonl") == "a/b.trace.json"


def test_enabled_spans_are_profiler_ranges():
    """While tracing, every span is a torch.profiler range, so a profile of
    the serve loop can attribute its work to prefill and decode."""
    tr = t_trace.Tracer()
    tr.configure(enabled=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("serve.prefill"):
            torch.ones(4).sum()
    assert "serve.prefill" in {e.key for e in prof.key_averages()}


def test_span_hands_its_body_the_attrs():
    """A body adds attributes it knows only at its end; a disabled tracer
    hands it None and records nothing."""
    tr = t_trace.Tracer()
    with tr.span("solve_fleet.round", m=1) as attrs:
        assert attrs is None
    tr.configure(enabled=True)
    with tr.span("solve_fleet.round", m=1) as attrs:
        attrs["host_syncs"] = 3
    assert [e.attrs for e in tr.events()] == [{"m": 1, "host_syncs": 3}]


def test_chrome_spans_share_the_profilers_clock(tmp_path):
    """The Chrome file's span starts and ends lie on torch.profiler's clock
    (Unix-epoch nanoseconds): within 1 ms of the span's own range in a CPU
    capture. The JSONL keeps seconds from the tracer's epoch."""
    tr = t_trace.Tracer()
    tr.configure(enabled=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("solve_fleet.call", batch=1):
            torch.ones(64).cumsum(0)
            with tr.span("solve_fleet.round", m=1):
                torch.ones(64).sum()
    tr.write_chrome_trace(tmp_path / "t.trace.json")
    chrome = {e["name"]: e for e in json.loads((tmp_path / "t.trace.json").read_text())["traceEvents"]}
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name() in chrome}
    assert ranges.keys() == chrome.keys()
    for name, (start_ns, end_ns) in ranges.items():
        ev = chrome[name]
        assert abs(ev["ts"] - start_ns / 1e3) < 1e3 and abs(ev["ts"] + ev["dur"] - end_ns / 1e3) < 1e3
    assert all(0 <= e.ts < 60 for e in tr.events())


def test_solve_fleet_spans_nest_round_by_round(tmp_path):
    """One traced `solve_fleet` on two iot instances: one `solve_fleet.call`
    root; one `solve_fleet.round` a round (m = 1..rounds) inside
    `solve_fleet.execute`, each holding exactly the placement, forwarding
    and eval spans in that order (besides its `device.sync` reads and its
    `kernels.neumann` solves); every span once per call but for the reads
    and the solves; the trace passes both validators."""
    from repro_torch.core import scenarios as t_scenarios
    from repro_torch.fleet import solve_fleet
    from repro_torch.obs.validate import validate_events

    problems = [t_scenarios.iot(device="cpu")] * 2
    t_trace.configure(enabled=True)
    t_trace.reset()
    try:
        res = solve_fleet(problems, m_max=3, t_phi=2, device="cpu")
        events = t_trace.TRACER.events()
        t_trace.TRACER.write_jsonl(tmp_path / "spans.jsonl")
    finally:
        t_trace.configure(enabled=False)
        t_trace.reset()
    by_id = {e.id: e for e in events}
    roots = [e for e in events if e.parent == -1]
    assert [e.name for e in roots] == ["solve_fleet.call"] and roots[0].attrs["batch"] == 2
    children = {}
    for e in sorted(events, key=lambda e: e.ts):
        if e.name not in ("device.sync", "kernels.neumann"):
            children.setdefault(e.parent, []).append(e)
    assert [e.name for e in children[roots[0].id]] == [
        "solve_fleet.validate", "solve_fleet.stack", "solve_fleet.execute", "solve_fleet.gather"]
    execute = children[roots[0].id][2]
    rounds = children[execute.id]
    assert res.rounds >= 2 and [e.attrs["m"] for e in rounds] == list(range(1, res.rounds + 1))
    assert {e.name for e in rounds} == {"solve_fleet.round"}
    for r in rounds:
        assert [e.name for e in children[r.id]] == [
            "solve_fleet.round.placement", "solve_fleet.round.forwarding", "solve_fleet.round.eval"]
        assert children[r.id][1].attrs == {"t_phi": 2} and r.attrs["host_syncs"] >= 1
    syncs = [e for e in events if e.name == "device.sync"]
    assert {e.attrs["site"] for e in syncs} == {"engine.exit_flag", "minplus.closure"}
    assert all(by_id[e.parent].name.startswith("solve_fleet.") for e in syncs)
    solves = [e for e in events if e.name == "kernels.neumann"]
    assert solves and {by_id[e.parent].name for e in solves} == {
        "solve_fleet.execute", "solve_fleet.round.forwarding", "solve_fleet.round.eval"}
    lines = (tmp_path / "spans.jsonl").read_text().splitlines()
    records, errors = validate_lines(lines)
    assert errors == [] and len(records) == len(events)
    assert validate_events(records) == []


def test_solve_fleet_neumann_spans_carry_the_solve(tmp_path):
    """Every `neumann_propagate` call of a traced `solve_fleet` on the CPU
    is one `kernels.neumann` span whose attributes are the host's view of
    the solve: the plain path's variant, the operators solved at once (the
    stacked lanes times the apps: one stage of phi a call), V, the operand
    size and the kernel's orientation (the traffic scan transposed, the
    cost-to-go not); with tracing off there is no span."""
    from repro_torch.core import scenarios as t_scenarios
    from repro_torch.fleet import solve_fleet

    problems = [t_scenarios.iot(device="cpu")] * 2
    t_trace.configure(enabled=True)
    t_trace.reset()
    try:
        solve_fleet(problems, m_max=2, t_phi=2, device="cpu")
        events = t_trace.TRACER.events()
    finally:
        t_trace.configure(enabled=False)
        t_trace.reset()
    solves = [e for e in events if e.name == "kernels.neumann"]
    v, apps = problems[0].net.n_nodes, problems[0].apps.src.shape[0]
    assert solves and {e.attrs["variant"] for e in solves} == {"plain"}
    assert {e.attrs["v"] for e in solves} == {v} and {e.attrs["esize"] for e in solves} == {4}
    assert {e.attrs["systems"] for e in solves} == {2 * apps}
    assert {e.attrs["transpose"] for e in solves} == {True, False}
    assert all(set(e.attrs) == {"variant", "systems", "v", "esize", "transpose"} for e in solves)
    solve_fleet(problems, m_max=1, t_phi=1, device="cpu")
    assert t_trace.TRACER.events() == []
