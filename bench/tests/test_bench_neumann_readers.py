"""The readers of the program's `kernels.neumann` spans: the wrapper's host
time a round, and the profiled re-plan's Neumann launches against the
least time their bytes need. Synthetic readings pin the arithmetic and the
None cases (no spans, only the plain path, a launched kind the profile
does not name); a traced run of the tiny re-plan cell on the CPU reads the
host time and, with no kernel launched, no share."""
from __future__ import annotations

import math
import types

import pytest

import harness
import roofline
from conftest import make_tiny_root

ROWS = "void (anonymous namespace)::neumann_rows_kernel<float>(float const*, long long, float const*)"
COLS = "void (anonymous namespace)::neumann_cols_kernel<float, true, false>(float const*, long long)"


def _span(sid, parent, name, dur=0.0, **attrs):
    return types.SimpleNamespace(id=sid, parent=parent, name=name, dur=dur, attrs=attrs)


def _solve(sid, parent, transpose, variant="c8_streamed", dur=0.002):
    return _span(sid, parent, "kernels.neumann", dur, variant=variant, systems=256, v=1024, esize=4,
                 transpose=transpose)


def _reading(cell, spans, device_ops, rounds=(2,)):
    return {"cell": cell, "record": {"replans": [{"rounds": r} for r in rounds]}, "spans": spans,
            "profile": {"busy_s": 1.0, "window_s": 1.0, "device_ops": device_ops, "idle_gaps": []},
            "state": {}}


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return harness.find_cell("tiny.replan", make_tiny_root(tmp_path_factory.mktemp("tiny")))


def _two_replans():
    """Two traced re-plans: the first (call 0) solves rows, cols and rows,
    one of them inside a round; the second (call 10) the same again."""
    spans = []
    for call in (0, 10):
        spans += [_solve(call + 2, call + 1, False), _solve(call + 4, call + 3, True),
                  _solve(call + 5, call + 1, False),
                  _span(call + 3, call + 1, "solve_fleet.round.forwarding"),
                  _span(call + 1, call, "solve_fleet.execute"), _span(call, -1, "solve_fleet.call")]
    return spans


def test_host_ms_is_the_spans_a_round(cell):
    reading = _reading(cell, _two_replans(), [], rounds=(3, 3))
    assert cell.reader("kernels.neumann_host_ms").read(reading) == pytest.approx(1e3 * 6 * 0.002 / 6)


def test_roofline_counts_the_first_replans_launches(cell):
    reading = _reading(cell, _two_replans(), [[ROWS, 0.5], [COLS, 0.1], ["void elementwise", 2.0]])
    want = 100.0 * 3 * 256 * (1024 ** 2 + 2 * 1024) * 4 / roofline.HBM_BYTES_PER_S / 0.6
    assert cell.reader("kernels.neumann_roofline_pct").read(reading) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_cols_kernel", "plain_path", "no_spans", "no_profile"])
def test_readers_without_what_they_read_give_none(cell, case):
    spans, ops = _two_replans(), [[ROWS, 0.5], [COLS, 0.1]]
    if case == "no_cols_kernel":
        ops = [[ROWS, 0.5]]
    elif case == "plain_path":
        spans = [s if s.name != "kernels.neumann" else _solve(s.id, s.parent, s.attrs["transpose"], "plain")
                 for s in spans]
    elif case == "no_spans":
        spans = [s for s in spans if s.name != "kernels.neumann"]
    reading = _reading(cell, spans, ops)
    if case == "no_profile":
        reading["profile"] = {}
    assert cell.reader("kernels.neumann_roofline_pct").read(reading) is None
    if case == "no_spans":
        assert cell.reader("kernels.neumann_host_ms").read(reading) is None


def test_traced_cpu_run_reads_host_time_and_no_share(tmp_path):
    root = make_tiny_root(tmp_path)
    result = harness.run_cell("tiny.replan", 2**31 + 17, 0.5, True, device="cpu", root=root)
    value = result["metrics"]["kernels.neumann_host_ms"]["value"]
    assert math.isfinite(value) and value > 0
    assert "kernels.neumann_roofline_pct" not in result["metrics"]
