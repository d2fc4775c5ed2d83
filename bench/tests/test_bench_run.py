"""The command line: no result without a card or without the program,
and on a card a whole run of the smallest cell."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT


def _run(root, *args, timeout=600):
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=root, capture_output=True,
                          text=True, timeout=timeout)


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path, "--workload", "fleet64.replan", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT, "--workload", "fleet64.replan", "--seed", "1", "--seconds", "1")
    assert out.returncode == 3 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_run_on_the_card(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shutil.copytree(ROOT / "src", tiny_root / "src", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tiny_root, "--workload", "tiny.replan", "--seed", str(2**31 + 5), "--seconds", "2",
               "--trace", "1")
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0 and list(result)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
