"""Nothing the benchmark runs loads JAX or the JAX package (`repro`),
comparing top-level module names whole, and the reference loads nothing
of the program."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import harness
from conftest import BENCH, ROOT


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.forbidden_modules()


def test_sources_import_no_jax_and_the_reference_no_program():
    for path in BENCH.rglob("*.py"):
        names = _imports(path)
        assert not names & set(harness.FORBIDDEN), path
        if "reference" in path.parts:
            assert "repro_torch" not in names, path


def test_a_run_loads_no_forbidden_module(tiny_root):
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(tiny_root / 'bench')!r}]
import harness
result = harness.run_cell("tiny.faults", 3, 5.0, True, device="cpu", root=harness.Path({str(tiny_root)!r}))
from reference import judge
print(json.dumps({{"forbidden": harness.forbidden_modules(), "correct": result["correct"]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"forbidden": [], "correct": True}


def test_the_reference_alone_loads_no_program():
    code = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}]
from reference import judge
print(sorted(m for m in sys.modules if m.split(".")[0] in ("repro_torch", "repro", "jax")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr
