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


def test_profile_round_phases_matches_jax_keys_and_spans(tmp_path):
    """The round-phase profile on two iot instances on the CPU: JAX's keys
    and batch / t_phi / block_apps, finite times, shares summing to 1, and
    the four spans nested as JAX's, passing the JAX package's validator."""
    from repro.core import scenarios as j_scenarios
    from repro.obs import profile_round_phases as j_profile
    from repro_torch.core import scenarios as t_scenarios
    from repro_torch.obs import profile_round_phases

    want = j_profile([j_scenarios.iot(), j_scenarios.iot()], t_phi=2, reps=1)
    t_trace.configure(enabled=True)
    t_trace.reset()
    try:
        got = profile_round_phases([t_scenarios.iot(device="cpu")] * 2, t_phi=2, reps=2, device="cpu")
        events = t_trace.TRACER.events()
        t_trace.TRACER.write_jsonl(tmp_path / "phases.jsonl")
    finally:
        t_trace.configure(enabled=False)
        t_trace.reset()
    assert list(got) == list(want)
    assert {k: got[k] for k in ("batch", "t_phi", "block_apps")} == {"batch": 2, "t_phi": 2, "block_apps": 1}
    assert all(np.isfinite(v) and v >= 0 for v in got.values())
    assert abs(sum(got[f"{k}_share"] for k in ("placement", "forwarding", "round_eval")) - 1) < 1e-3
    by_name = {e.name: e for e in events}
    assert set(by_name) == {"round.phases", "round.placement", "round.forwarding", "round.round_eval"}
    assert all(by_name[n].parent == by_name["round.phases"].id for n in by_name if n != "round.phases")
    assert by_name["round.forwarding"].attrs == {"t_phi": 2}
    _, errors = validate_lines((tmp_path / "phases.jsonl").read_text().splitlines())
    assert errors == []
