"""The harness finds every configuration, cell and per-layer metric by its
name, and a new cell, configuration and metric are added as files only."""
from __future__ import annotations

import json
import re
from pathlib import Path

import harness

ROOT = Path(harness.ROOT)
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_config_and_metric_resolves():
    for w in BENCHMARK["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.chips == 1
        assert hasattr(cell.driver(), "window")
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
    for c in BENCHMARK["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_names_units_and_bounds_keep_to_the_contract():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCHMARK[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in layers
        for cell in m["workloads"]:
            reported = layers[m["moves"]].get("workloads")
            assert reported is None or cell in reported
    assert len(json.dumps(BENCHMARK)) < 64 * 1024


def test_a_new_cell_config_and_metric_are_files_only(tiny_root):
    before = {p: p.read_bytes() for p in (tiny_root / "bench").rglob("*") if p.is_file()}
    metric = tiny_root / "bench" / "metrics" / "engine.replans.py"
    metric.write_text("def read(reading):\n    return len(reading['record']['replans'])\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "engine.replans", "unit": "replans", "better": "higher",
                               "source": "program_counter", "layer": "round engine",
                               "moves": "networks_per_s", "workloads": ["tiny.replan"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell("tiny.replan", tiny_root)
    assert cell.config["name"] == "tiny" and cell.traffic["driver"] == "replan"
    assert "engine.replans" in {m["name"] for m in cell.per_layer}
    assert cell.reader("engine.replans").read({"record": {"replans": [1, 2]}}) == 2
    faults = harness.find_cell("tiny.faults", tiny_root)
    assert faults.traffic["epochs"] == 6 and faults.per_layer
    for path, data in before.items():
        assert path.read_bytes() == data, f"{path} was edited"
