"""On a tiny fleet solved on the CPU, the plain reference reproduces the
program's J, its congestion-unaware plan is the program's CongUnaware
baseline, and the control (the reference in the program's place, in
bfloat16) fails the comparison."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import program
import roofline
from conftest import BENCH, TINY_FLEET
from gen import networks
from reference import judge as ref

LIMITS = json.loads((BENCH / "workloads" / "fleet64.replan.json").read_text())


@pytest.fixture(scope="module")
def solved():
    from repro_torch.fleet import solve_fleet

    cfg = json.loads((BENCH / "configs" / "edge_fleet64.json").read_text())
    nets = networks.build(dict(cfg, fleet=TINY_FLEET), 3)
    probs = [program.to_problem(n, "cpu") for n in nets]
    kw = dict(program.solver_kwargs(cfg), device="cpu")
    res = solve_fleet(probs, keep_state=True, **kw)
    cu = solve_fleet(probs, **dict(kw, method="CongUnaware"))
    return [ref.apply_health(n, None) for n in nets], probs, res, cu


def test_reference_reproduces_the_programs_answer(solved):
    nets, _, res, _ = solved
    rows, share = ref.judge_fleet(nets, res.state.x, res.state.phi, res.J, res.hosts)
    for row in rows:
        assert row["j_gap"] <= 1e-5 and row["mass_err"] <= 1e-5
        assert row["leak"] == 0.0 and row["bad_hosts"] == 0
    assert share < 1.0
    assert np.allclose([r["J"] for r in rows], res.J, rtol=1e-5)


def test_baseline_is_the_programs_congestion_unaware_plan(solved):
    nets, _, _, cu = solved
    got = [ref.baseline(net, "cpu") for net in nets]
    assert np.allclose(got, cu.J, rtol=1e-5)


def test_control_fails_the_comparison(solved):
    nets, _, res, _ = solved
    lo = [ref.control_answer(net, res.state.x[b], res.state.phi[b]) for b, net in enumerate(nets)]
    rows, _ = ref.judge_fleet(nets, res.state.x, torch.stack([p for _, p in lo]),
                              np.array([j for j, _ in lo]), res.hosts)
    assert max(r["j_gap"] for r in rows) > LIMITS["j_gap"]
    assert max(r["mass_err"] for r in rows) > LIMITS["mass_err"]


def test_an_altered_answer_fails(solved):
    nets, _, res, _ = solved
    phi = res.state.phi.clone()
    phi[0, 0] *= 0.99
    rows, _ = ref.judge_fleet(nets, res.state.x, phi, res.J * 1.001, res.hosts)
    assert rows[0]["mass_err"] > LIMITS["mass_err"] or rows[0]["leak"] > LIMITS["leak"]
    assert all(r["j_gap"] > LIMITS["j_gap"] for r in rows)


def test_hop_bound_is_the_programs(solved):
    nets, probs, _, _ = solved
    assert [roofline.hop_bound(n["adj"]) for n in nets] == [p.hop_bound for p in probs]
    work = roofline.round_work(nets, 5)
    assert work["seconds"] == max(work["bytes"] / roofline.HBM_BYTES_PER_S,
                                  work["ops"] / roofline.FP32_OPS_PER_S) > 0
