"""The readers of the program's spans inside a re-plan (the round phases,
the host's waits on the device and its syncs, the input checks): each
reads a finite number from a traced run of the tiny re-plan cell on the
CPU, and None from a reading without those spans, as a program that
lacks them gives."""
from __future__ import annotations

import math
import types

import pytest

import harness
from conftest import make_tiny_root

READERS = ("phases.placement_ms", "phases.forwarding_ms", "phases.eval_ms", "engine.host_wait_ms",
           "engine.host_syncs", "fleet.validate_ms", "fleet.host_syncs")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("tiny"))
    return harness.run_cell("tiny.replan", 2**31 + 9, 0.5, True, device="cpu", root=root)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_traced_run(traced, name):
    value = traced["metrics"][name]["value"]
    assert math.isfinite(value) and value > 0, traced["metrics"]


def test_phases_lie_inside_the_round(traced):
    m = {k: v["value"] for k, v in traced["metrics"].items()}
    phases = m["phases.placement_ms"] + m["phases.forwarding_ms"] + m["phases.eval_ms"]
    assert phases <= m["engine.round_ms"] and m["engine.host_wait_ms"] <= m["engine.round_ms"]
    assert m["engine.host_syncs"] >= 1 and m["fleet.host_syncs"] > m["engine.host_syncs"]


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_spans_reads_none(tiny_root, name):
    cell = harness.find_cell("tiny.replan", tiny_root)
    spans = [types.SimpleNamespace(id=i, parent=-1, name=n, dur=0.01, attrs={"batch": 4})
             for i, n in enumerate(("solve_fleet.stack", "solve_fleet.execute", "solve_fleet.gather"))]
    reading = {"cell": cell, "record": {"replans": [{"rounds": 3}]}, "spans": spans, "profile": {},
               "state": {}}
    assert cell.reader(name).read(reading) is None
