"""The benchmark's frozen generators draw exactly the program's inputs,
the run's seed draws other networks of the configuration's shapes, and
the reference's reading of a fault state is the program's."""
from __future__ import annotations

import json

import numpy as np
import pytest

import harness
from conftest import BENCH
from gen import faults, networks
from reference import judge as ref
from repro_torch import chaos
from repro_torch.core.scenarios import random_connected
from repro_torch.fleet import sample_fleet

KEYS = {"adj": "net.adj", "mu": "net.mu", "nu": "net.nu", "src": "apps.src", "dst": "apps.dst",
        "lam": "apps.lam", "L": "apps.L", "w": "apps.w", "parts": "apps.parts"}


def _same(program_problem, arrays):
    got = program_problem.to_numpy()
    for key, path in KEYS.items():
        assert got[path].shape == arrays[key].shape, key
        assert np.array_equal(got[path], arrays[key]), key


@pytest.mark.parametrize("partitions", [None, (1, 2, 3)])
def test_sample_fleet_is_the_programs(partitions):
    kw = dict(seed=5, n_range=(20, 36), apps_range=(4, 9), partitions=partitions)
    for prog, mine in zip(sample_fleet(8, device="cpu", **kw), networks.sample_fleet(8, **kw)):
        _same(prog, mine)


@pytest.mark.parametrize("n,apps,seed", [(24, 6, 1), (40, 9, 7)])
def test_random_connected_is_the_programs(n, apps, seed):
    _same(random_connected(n, apps, seed=seed, device="cpu"), networks.random_connected(n, apps, seed=seed))


def test_fault_trace_and_health_are_the_programs():
    kw = dict(seed=2, n_range=(14, 22), apps_range=(3, 6), partitions=(1, 2))
    prog = sample_fleet(6, device="cpu", **kw)
    mine = networks.sample_fleet(6, **kw)
    tkw = dict(seed=9, node_failures=4, link_degradations=4, flash_crowds=2)
    theirs = chaos.generate_trace(prog, 12, **tkw)
    events = faults.generate_trace(mine, 12, **tkw)
    assert [e.to_dict() for e in theirs.events] == [dict(e, edge=list(e["edge"])) for e in events]
    healths = faults.healths_by_epoch(events, 12, 6)
    for epoch, _, hs in theirs.timeline():
        for lane, h in enumerate(hs):
            perturbed, live = chaos.apply_health(prog[lane], h)
            net = ref.apply_health(mine[lane], healths[epoch][lane])
            got = perturbed.to_numpy()
            assert np.array_equal(got["net.adj"], net["adj"])
            assert np.array_equal(got["apps.lam"], net["lam"])
            on = net["adj"] > 0
            assert np.array_equal(got["net.mu"][on], net["mu"][on])
            assert np.array_equal(live > 0, net["live"])


@pytest.mark.parametrize("config", ["edge_fleet64", "scale_tier256"])
def test_seeds_draw_other_networks_of_the_same_shapes(config):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    count = "n_instances" if "n_instances" in cfg["fleet"] else "n_networks"
    cfg = dict(cfg, fleet=dict(cfg["fleet"], **{count: 3}))
    a, b = (networks.build(cfg, harness.input_seed(s)) for s in (2**31 + 11, 12))
    for x, y in zip(a, b):
        assert {k: v.shape for k, v in x.items()} == {k: v.shape for k, v in y.items()}
    assert any(not np.array_equal(x["adj"], y["adj"]) for x, y in zip(a, b))


def test_judged_lanes_are_drawn_from_the_seed():
    class Run:
        def __init__(self, seed, traffic):
            self.seed, self.cell = seed, type("Cell", (), {"traffic": traffic})()

    assert list(harness.judged_lanes(Run(5, {}), 4)) == [0, 1, 2, 3]
    a, b = (harness.judged_lanes(Run(2**31 + 3, {"judge_lanes": 16}), 64) for _ in range(2))
    assert len(set(a)) == 16 and list(a) == sorted(a) and np.array_equal(a, b)
    assert not np.array_equal(a, harness.judged_lanes(Run(4, {"judge_lanes": 16}), 64))
