"""Shared fixtures of the benchmark's own tests: a tiny copy of the
benchmark (three networks of at most 20 nodes, on the CPU) that the
harness runs end to end, with the program's path intact or broken."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_FLEET = {"generator": "sample_fleet", "n_instances": 4, "n_range": [12, 20],
              "apps_range": [3, 6], "load_range": [0.9, 1.2], "partitions": [1, 2, 3]}
TINY_SOLVER = {"m_max": 3, "t_phi": 2}
TINY_FAULTS = {"epochs": 6, "node_failures": 2, "link_degradations": 2, "flash_crowds": 1,
               "warmup_epochs": 2, "sample_epochs": 2, "sample_before": 6, "profile_first_epoch": 1,
               "profile_epochs": 2}
# The faults mix's metrics, which no cell of BENCHMARK.json reports while
# the faults cell is out (PERF.md, Open questions): the tiny cell adds them.
FAULTS_METRICS = {
    "end_to_end": [{"name": "recovery_s", "unit": "s", "better": "lower", "bound": 0.05,
                    "source": "host_clock", "workloads": ["tiny.faults"]}],
    "per_layer": [
        {"name": n, "unit": u, "better": "lower", "source": src, "layer": layer,
         "moves": "recovery_s", "workloads": ["tiny.faults"]}
        for n, u, src, layer in (
            ("control.warm_rounds", "rounds", "program_counter", "control plane"),
            ("control.host_ms", "ms", "program_span", "control plane"),
            ("device.idle_pct.faults", "%", "device_trace", "device"))],
}
# Limits of the tiny cells: the cells' own, but for the share of
# networks the congestion-unaware plan already serves best, which is
# larger among four small networks.
TINY_UNIMPROVED = 0.3


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips inside the test without one")
    # Runs are timed windows: one thread a worker keeps parallel workers
    # from starving one another's windows of event epochs.
    import torch
    torch.set_num_threads(1)


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)


def make_tiny_root(tmp_path: Path) -> Path:
    """A checkout-like root holding a copy of `bench/` and `BENCHMARK.json`
    with two extra cells, `tiny.replan` and `tiny.faults`, over a tiny
    fleet; the copied files are left as they are, the extra ones added."""
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "edge_fleet64.json").read_text())
    cfg.update(name="tiny", fleet=TINY_FLEET, solver=dict(cfg["solver"], **TINY_SOLVER))
    (tmp_path / "bench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = dict(json.loads((BENCH / "traffic" / "faults.json").read_text()), **TINY_FAULTS)
    (tmp_path / "bench" / "traffic" / "tiny_faults.json").write_text(json.dumps(traffic))
    for cell, base in (("tiny.replan", "fleet64.replan"), ("tiny.faults", "fleet64.replan")):
        limits = json.loads((BENCH / "workloads" / f"{base}.json").read_text())
        limits["unimproved"] = TINY_UNIMPROVED
        (tmp_path / "bench" / "workloads" / f"{cell}.json").write_text(json.dumps(limits))
    bench["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/2604.25571",
                             "file": "bench/configs/tiny.json", "reduced": [], "why": "tests"})
    bench["workloads"] += [
        {"name": "tiny.replan", "config": "tiny", "traffic": "replan", "chips": 1, "why": "tests"},
        {"name": "tiny.faults", "config": "tiny", "traffic": "tiny_faults", "chips": 1, "why": "tests"},
    ]
    for m in bench["end_to_end"] + bench["per_layer"]:
        cells = m.get("workloads")
        if cells is not None and any(c.endswith("replan") for c in cells):
            cells.append("tiny.replan")
    for key, metrics in FAULTS_METRICS.items():
        bench[key] += [dict(m, workloads=list(m["workloads"])) for m in metrics]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path
