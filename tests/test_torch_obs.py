"""Port parity: the serve path's observability (repro_torch.obs) against the
JAX package's `obs/metrics.py` and `obs/trace.py`: the same operations give
the same snapshots, and the port's span files pass the JAX package's
validator."""
import json

import numpy as np
import pytest
import torch

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
