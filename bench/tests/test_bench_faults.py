"""A whole run of each kind of cell, on a tiny fleet on the CPU, with the
timed path intact and then broken underneath (`bench/plant.py`): `correct`
has to come out true, then false for each fault the cell can have. (The
cells run on one chip, so no exchange between chips can be left out.)"""
from __future__ import annotations

import numpy as np
import pytest

import harness
from plant import FAULTS, planted


@pytest.mark.parametrize("cell", ["tiny.replan", "tiny.faults"])
@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_correct_catches_each_fault(tiny_root, cell, fault):
    seconds = 5.0 if cell == "tiny.faults" else 0.5  # the faults window passes event epochs
    with planted(fault):
        result = harness.run_cell(cell, 7, seconds, False, device="cpu", root=tiny_root)
    assert result["correct"] is (fault is None), result
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and np.isfinite(list(result["metrics"].values())[0]["value"])
