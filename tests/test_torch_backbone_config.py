"""The benchmark's `scale_backbone1024` configuration cut to a size the
CPU runs (V 48, A 12; its budget, cost and partitions as they are): the
benchmark's frozen generator (`bench/gen/`) draws bitwise the network the
program's `random_connected` builds, and the program's `solve_fleet`
answer for it passes the plain float64 reference
(`bench/reference/judge.py`, which imports nothing of the program) at the
`backbone1024.replan` cell's limits."""
import json
from pathlib import Path

import numpy as np
import pytest

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro_torch.core.scenarios import random_connected
from repro_torch.fleet import solve_fleet

BENCH = Path(__file__).resolve().parents[1] / "bench"
CONFIG = json.loads((BENCH / "configs" / "scale_backbone1024.json").read_text())
LIMITS = json.loads((BENCH / "workloads" / "backbone1024.replan.json").read_text())
V, APPS = 48, 12
KEYS = {"adj": "net.adj", "mu": "net.mu", "nu": "net.nu", "src": "apps.src", "dst": "apps.dst",
        "lam": "apps.lam", "L": "apps.L", "w": "apps.w", "parts": "apps.parts"}


@pytest.fixture
def bench_modules(monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))
    from gen import networks
    from reference import judge

    return networks, judge


@pytest.mark.parametrize("seed", [5, 2_000_000_011])
def test_cut_backbone_is_drawn_and_solved_as_the_cell_judges(bench_modules, seed):
    networks, judge = bench_modules
    cfg = dict(CONFIG, fleet=dict(CONFIG["fleet"], n=V, n_apps=APPS))
    (net,) = networks.build(cfg, seed)
    prob = random_connected(V, APPS, seed=seed, device="cpu")
    got = prob.to_numpy()
    for key, path in KEYS.items():
        assert got[path].shape == net[key].shape and np.array_equal(got[path], net[key]), key

    s = cfg["solver"]
    res = solve_fleet([prob], m_max=s["m_max"], t_phi=s["t_phi"], tol=s["tol"], patience=s["patience"],
                      block_apps=s["block_apps"], solver=s["linear_solver"], round_to=s["round_to"],
                      keep_state=True, device="cpu")
    assert res.rounds == s["m_max"]  # patience = m_max: every re-plan runs the whole budget
    rows, unimproved = judge.judge_fleet([judge.apply_health(net, None)], res.state.x, res.state.phi,
                                         res.J, res.hosts)
    assert unimproved <= LIMITS["unimproved"]
    for key, limit in LIMITS.items():
        if key != "unimproved":
            assert rows[0][key] <= limit, (key, rows[0][key], limit)
