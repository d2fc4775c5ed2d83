"""The benchmark's `edge_mixed2048` configuration cut to 8 lanes (each
family at its own split depth, twice; its sizes, budget and cost as they
are): the benchmark's frozen generator (`bench/gen/`) draws bitwise the
fleet the program's `sample_fleet` builds, the program's `solve_fleet`
answer passes the plain float64 reference (`bench/reference/judge.py`,
which imports nothing of the program) at the `mixed2048.replan` cell's
limits, and the whole 2,048-lane fleet pads to the configuration's stated
envelope. Then the padding path's tracing: the `solve_fleet.pad` span,
the stack span's cell counts, and the two readers of `bench/metrics/`
that read them."""
import json
import types
from pathlib import Path

import numpy as np
import pytest

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro_torch.fleet import sample_fleet, solve_fleet
from repro_torch.obs import sync as t_sync
from repro_torch.obs import trace as t_trace

BENCH = Path(__file__).resolve().parents[1] / "bench"
CONFIG = json.loads((BENCH / "configs" / "edge_mixed2048.json").read_text())
LIMITS = json.loads((BENCH / "workloads" / "mixed2048.replan.json").read_text())
LANES = 8
KEYS = {"adj": "net.adj", "mu": "net.mu", "nu": "net.nu", "src": "apps.src", "dst": "apps.dst",
        "lam": "apps.lam", "L": "apps.L", "w": "apps.w", "parts": "apps.parts"}


@pytest.fixture
def bench_modules(monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))
    import harness
    from gen import networks
    from reference import judge

    return types.SimpleNamespace(networks=networks, judge=judge, harness=harness)


def _cut(lanes=LANES):
    return dict(CONFIG, fleet=dict(CONFIG["fleet"], n_instances=lanes))


def _programs(seed, lanes=LANES):
    fleet = {k: tuple(v) if isinstance(v, list) else v for k, v in _cut(lanes)["fleet"].items()
             if k != "generator"}
    return sample_fleet(seed=seed, device="cpu", **fleet)


def _solver(**over):
    s = CONFIG["solver"]
    kw = dict(m_max=s["m_max"], t_phi=s["t_phi"], tol=s["tol"], patience=s["patience"],
              block_apps=s["block_apps"], solver=s["linear_solver"], round_to=s["round_to"])
    return dict(kw, **over)


@pytest.mark.parametrize("seed", [5, 2_000_000_011])
def test_cut_fleet_is_the_programs_families_at_their_depths(bench_modules, seed):
    nets = bench_modules.networks.build(_cut(), seed)
    progs = _programs(seed)
    assert len(nets) == len(progs) == LANES
    for prog, net in zip(progs, nets):
        got = prog.to_numpy()
        for key, path in KEYS.items():
            assert got[path].shape == net[key].shape and np.array_equal(got[path], net[key]), key
    depths = CONFIG["fleet"]["partitions"]
    assert [int(n["parts"][0]) for n in nets] == [depths[i % len(depths)] for i in range(LANES)]
    assert all((n["parts"] == n["parts"][0]).all() for n in nets)


def test_cut_fleet_is_solved_as_the_cell_judges(bench_modules):
    judge = bench_modules.judge
    nets = bench_modules.networks.build(_cut(), 2_000_000_011)
    res = solve_fleet(_programs(2_000_000_011), **_solver(), keep_state=True, device="cpu")
    # The cut keeps the envelope's K; its V and A are the cut's own.
    assert res.state.phi.shape[2] == CONFIG["envelope"]["K"]
    rows, unimproved = judge.judge_fleet([judge.apply_health(n, None) for n in nets], res.state.x,
                                         res.state.phi, res.J, res.hosts)
    assert unimproved <= LIMITS["unimproved"]
    for key, limit in LIMITS.items():
        if key != "unimproved":
            worst = max(row[key] for row in rows)
            assert worst <= limit, (key, worst, limit)


@pytest.mark.parametrize("seed", [11, 2**31 + 7])
def test_whole_fleet_pads_to_the_stated_envelope(bench_modules, seed):
    """Two runs' seeds draw other networks into the same envelope; about
    83% of phi's envelope is padding and phantom stages."""
    nets = bench_modules.networks.build(CONFIG, bench_modules.harness.input_seed(seed))
    step = CONFIG["solver"]["round_to"]

    def up(x):
        return -(-x // step) * step

    env = CONFIG["envelope"]
    assert up(max(n["adj"].shape[0] for n in nets)) == env["V"]
    assert up(max(n["src"].shape[0] for n in nets)) == env["A"]
    assert max(int(n["parts"][0]) for n in nets) + 1 == env["K"]
    real = sum(n["src"].shape[0] * (int(n["parts"][0]) + 1) * n["adj"].shape[0] ** 2 for n in nets)
    padding = 100.0 * (1.0 - real / (len(nets) * env["A"] * env["K"] * env["V"] ** 2))
    assert 80.0 <= padding <= 86.0


def _traced(problems, **kw):
    t_trace.configure(enabled=True)
    t_trace.reset()
    try:
        first = t_sync.host_syncs()
        solve_fleet(problems, **kw)
        return t_trace.TRACER.events(), t_sync.host_syncs() - first
    finally:
        t_trace.configure(enabled=False)
        t_trace.reset()


def test_pad_and_stack_spans_count_the_padding():
    """A traced `solve_fleet` over a small mixed fleet at an exact envelope
    (`round_to` 1): one `solve_fleet.pad` inside `solve_fleet.stack`
    counting the lanes whose (V, A, P) is not the envelope's, and the
    stack's real and envelope cells equal to the sums from the shapes."""
    problems = _programs(5, lanes=6)
    v = max(p.net.n_nodes for p in problems)
    a = max(p.apps.n_apps for p in problems)
    deep = max(p.apps.n_parts for p in problems)
    fits = [(p.net.n_nodes, p.apps.n_apps, p.apps.n_parts) == (v, a, deep) for p in problems]
    events, _ = _traced(problems, **_solver(m_max=1, t_phi=1, round_to=1), device="cpu")
    by_id = {e.id: e for e in events}
    (pad,) = [e for e in events if e.name == "solve_fleet.pad"]
    (stack,) = [e for e in events if e.name == "solve_fleet.stack"]
    assert by_id[pad.parent] is stack and pad.attrs == {"lanes_padded": len(fits) - sum(fits)}
    real = sum(p.apps.n_apps * (p.apps.n_parts + 1) * p.net.n_nodes ** 2 for p in problems)
    assert stack.attrs["real_cells"] == real
    assert stack.attrs["envelope_cells"] == len(problems) * a * (deep + 1) * v ** 2
    assert 0 < real < stack.attrs["envelope_cells"]


def test_tracing_adds_no_host_sync():
    problems = _programs(2_000_000_011, lanes=4)
    kw = dict(_solver(m_max=1, t_phi=1), device="cpu")
    first = t_sync.host_syncs()
    solve_fleet(problems, **kw)
    untraced = t_sync.host_syncs() - first
    events, traced = _traced(problems, **kw)
    (call,) = [e for e in events if e.name == "solve_fleet.call"]
    assert traced == untraced == call.attrs["host_syncs"]


def _span(i, name, dur, parent=-1, **attrs):
    return types.SimpleNamespace(id=i, parent=parent, name=name, dur=dur, attrs=attrs)


def _reader(bench_modules, name):
    return bench_modules.harness.load_module(BENCH / "metrics" / f"{name}.py")


def test_readers_read_the_padding_path(bench_modules):
    spans = [_span(0, "solve_fleet.pad", 0.004, 1, lanes_padded=3),
             _span(1, "solve_fleet.stack", 0.010, real_cells=300, envelope_cells=1200),
             _span(2, "solve_fleet.pad", 0.002, 3, lanes_padded=3),
             _span(3, "solve_fleet.stack", 0.012, real_cells=100, envelope_cells=400)]
    reading = {"record": {"replans": [{"rounds": 8}, {"rounds": 8}]}, "spans": spans}
    assert _reader(bench_modules, "fleet.pad_ms").read(reading) == pytest.approx(3.0)
    assert _reader(bench_modules, "fleet.padding_pct").read(reading) == pytest.approx(75.0)
    unpadded = dict(reading, spans=[_span(1, "solve_fleet.stack", 0.01, real_cells=8, envelope_cells=8)])
    assert _reader(bench_modules, "fleet.padding_pct").read(unpadded) == 0.0


@pytest.mark.parametrize("name", ["fleet.pad_ms", "fleet.padding_pct"])
def test_readers_read_none_without_their_spans(bench_modules, name):
    """A program without the padding spans or the stack's cell counts (as
    one that predates them) reads None, and so does a window without
    re-plans."""
    old = [_span(0, "solve_fleet.stack", 0.01, batch=4, real=4), _span(1, "solve_fleet.execute", 0.1)]
    reader = _reader(bench_modules, name)
    assert reader.read({"record": {"replans": [{"rounds": 8}]}, "spans": old}) is None
    assert reader.read({"record": {}, "spans": []}) is None
