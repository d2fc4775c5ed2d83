"""The port's split-point Pareto search against the JAX package's, on the
CPU: profiles, candidate sets and `Apps` bitwise for all twelve zoo
configs, `pareto_front` on hypothesis-drawn points, a small `sweep_zoo`
(J at rtol 1e-5, fronts equal up to near-ties) and the Pareto CLI.

Fronts are compared up to near-ties: the reference's own fronts keep
candidates whose objectives tie exactly (mamba2-370m's cuts [47], [46, 47]
and [45, 46, 47] all put every partition on one host), and ulp-level
differences of the port's arithmetic can order such points. An index on
one front only must have a partner on the other front whose latency,
compute and egress agree with its own within rtol 1e-5, the J tolerance,
in both reports (`repro_torch.partition.pareto.fronts_agree`)."""
import dataclasses
import json

import numpy as np
import pytest

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro.configs import ZOO as J_ZOO
from repro.configs import get_config as j_config
from repro.launch import pareto as j_cli
from repro.partition import pareto as jpar
from repro.partition import profile as jprof
from repro_torch.configs import ZOO
from repro_torch.configs import get_config
from repro_torch.launch import pareto as t_cli
from repro_torch.partition import pareto as tpar
from repro_torch.partition import profile as tprof
from tests._optional_deps import given, settings, st

SWEEP_KW = dict(archs=("qwen1.5-0.5b", "mamba2-370m"), topologies=("iot",), max_per_p=2, m_max=2, t_phi=2)
OBJECTIVES = ("latency", "compute", "egress")


def test_zoo_is_the_reference_zoo():
    assert ZOO == J_ZOO and len(ZOO) == 12


@pytest.mark.parametrize("arch", ZOO)
def test_profiles_bitwise(arch):
    """The P=2 default and two multi-cut sets (plus P=1) profile bitwise
    as in JAX, and so does the whole candidate enumeration."""
    jc, tc = j_config(arch), get_config(arch)
    total = tprof.total_profile_layers(tc)
    assert total == jprof.total_profile_layers(jc)
    assert tprof.layer_flops_table(tc, 256) == jprof.layer_flops_table(jc, 256)
    for kw in ({}, {"splits": ()}, {"splits": (1, 2)}, {"splits": (1, total // 2, total - 1)},
               {"seq_len": 777, "n_out_tokens": 5}):
        want, got = jprof.profile_arch(jc, **kw), tprof.profile_arch(tc, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), kw
        assert got.n_parts == want.n_parts and got.L == want.L and got.w == want.w
    for kw in ({}, {"max_per_p": 3, "parts": (2, 4)}):
        want, n_want = jprof.enumerate_candidates(jc, seq_len=256, **kw)
        got, n_got = tprof.enumerate_candidates(tc, seq_len=256, **kw)
        assert n_got == n_want
        assert [dataclasses.asdict(p) for p in got] == [dataclasses.asdict(p) for p in want]
    for bad in ({"splits": (0,)}, {"splits": (2, 1)}, {"split": 1, "splits": (1,)}):
        with pytest.raises(ValueError) as w:
            jprof.profile_arch(jc, **bad)
        with pytest.raises(ValueError) as g:
            tprof.profile_arch(tc, **bad)
        assert str(g.value) == str(w.value)


def test_apps_from_profiles_bitwise():
    """Mixed-depth profiles of three archs pad to one stage envelope: every
    array bitwise JAX's (index tensors int64 in the port, int32 out)."""
    profs_j = [jprof.profile_arch(j_config(a), splits=s) for a, s in
               (("qwen1.5-0.5b", ()), ("hymba-1.5b", (3, 9, 20)), ("seamless-m4t-medium", (12,)))]
    profs_t = [tprof.profile_arch(get_config(a), splits=s) for a, s in
               (("qwen1.5-0.5b", ()), ("hymba-1.5b", (3, 9, 20)), ("seamless-m4t-medium", (12,)))]
    src, dst, lam = np.array([0, 3, 5]), np.array([7, 1, 5]), np.array([2.5, 3.0, 1.25])
    kw = dict(byte_scale=1e-6, flop_scale=1e-9)
    want = jprof.apps_from_profiles(profs_j, src, dst, lam, **kw)
    got = tprof.apps_from_profiles(profs_t, src, dst, lam, device="cpu", **kw)
    for k in ("src", "dst", "lam", "L", "w", "parts"):
        a, b = np.asarray(getattr(want, k)), getattr(got, k).numpy()
        assert b.dtype == (np.int64 if a.dtype == np.int32 else a.dtype) and np.array_equal(a, b), k
    assert got.parts.tolist() == [1, 4, 2]
    for bad in (dict(src=src[:2]), dict(byte_scale=0.0), dict(flop_scale=np.inf)):
        args = dict(src=src, dst=dst, lam=lam, **kw)
        args.update(bad)
        with pytest.raises(ValueError) as w:
            jprof.apps_from_profiles(profs_j, **args)
        with pytest.raises(ValueError) as g:
            tprof.apps_from_profiles(profs_t, device="cpu", **args)
        assert str(g.value) == str(w.value)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.lists(st.integers(0, 6), min_size=3, max_size=3), min_size=1, max_size=24),
       st.integers(0, 3))
def test_pareto_front_matches_jax(rows, scale_exp):
    """Small integer objectives make duplicates and exact ties common."""
    pts = np.asarray(rows, np.float64) * 10.0 ** -scale_exp
    assert np.array_equal(tpar.pareto_front(pts), jpar.pareto_front(pts))


def test_pareto_front_rejects_bad_shape():
    with pytest.raises(ValueError, match="expected"):
        tpar.pareto_front(np.zeros(4))


@pytest.fixture(scope="module")
def sweeps():
    return jpar.sweep_zoo(**SWEEP_KW), tpar.sweep_zoo(device="cpu", **SWEEP_KW)


def test_sweep_zoo_matches_jax(sweeps):
    want, got = sweeps
    assert got.keys() == want.keys()
    for k in want:
        if k != "cells":
            assert got[k] == want[k], k
    assert len(got["cells"]) == 2
    swapped = {}
    for a, b in zip(want["cells"], got["cells"], strict=True):
        assert {k: a[k] for k in ("arch", "topology", "load", "n_points")} == \
            {k: b[k] for k in ("arch", "topology", "load", "n_points")}
        for p, q in zip(a["points"], b["points"], strict=True):
            assert {k: p[k] for k in ("splits", "parts", "eta")} == {k: q[k] for k in ("splits", "parts", "eta")}
            np.testing.assert_allclose([q[k] for k in ("J",) + OBJECTIVES], [p[k] for k in ("J",) + OBJECTIVES],
                                       rtol=1e-5)
        swapped[a["arch"]] = tpar.fronts_agree(a, b, 1e-5)
        assert b["front_size"] == len(b["front"]) and b["n_dominated"] == b["n_points"] - b["front_size"]
    tpar.check_fronts(got)
    assert swapped["qwen1.5-0.5b"] == []


def test_fronts_agree_accepts_near_ties_only():
    """A swap between points tied to rtol is accepted and returned; one whose
    partner differs beyond rtol in either report raises."""
    pts = [{"latency": 1.0, "compute": 0.5, "egress": 2.0}, {"latency": 1.0 + 1e-7, "compute": 0.5, "egress": 2.0},
           {"latency": 3.0, "compute": 0.1, "egress": 0.0}]
    ref = {"arch": "a", "topology": "iot", "load": 1.0, "front": [0, 2], "points": pts}
    assert tpar.fronts_agree(ref, {**ref, "front": [1, 2]}, 1e-5) == [0, 1]
    assert tpar.fronts_agree(ref, ref, 1e-5) == []
    far = [pts[0], {**pts[1], "egress": 2.1}, pts[2]]
    with pytest.raises(ValueError, match="index 0 has no near-tie partner"):
        tpar.fronts_agree(ref, {**ref, "front": [1, 2], "points": far}, 1e-5)


def test_check_fronts_errors_match_jax(sweeps):
    _, got = sweeps
    cell = next(c for c in got["cells"] if c["front_size"] > 1)
    broken = [
        {**got, "cells": []},
        {**got, "cells": [{**cell, "front": []}]},
        {**got, "cells": [{**cell, "front": cell["front"][:1]}]},
        {**got, "cells": [{**cell, "n_dominated": 0}]},
        {**got, "cells": [{**cell, "points": [{**cell["points"][0], "J": 1.0, "latency": np.nan}]
                           + cell["points"][1:]}]},
    ]
    for rep in broken:
        with pytest.raises(ValueError) as w:
            jpar.check_fronts(rep)
        with pytest.raises(ValueError) as g:
            tpar.check_fronts(rep)
        assert str(g.value) == str(w.value)
    with pytest.raises(ValueError, match="unknown topology"):
        tpar.sweep_zoo(topologies=("torus",), device="cpu")
    with pytest.raises(ValueError, match="eta"):
        tpar.sweep_zoo(etas=(1.5,), device="cpu")


def test_cli_json_matches_jax(tmp_path, capsys):
    argv = ["--archs", "qwen1.5-0.5b", "--topologies", "iot", "--max-per-p", "2", "--m-max", "2",
            "--t-phi", "2", "--parts", "1,2", "--assert-front"]
    assert j_cli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    out = tmp_path / "fronts.json"
    assert t_cli.main(argv + ["--device", "cpu", "--json-out", str(out), "--plot-out", str(tmp_path / "plots")]) == 0
    summary = json.loads(capsys.readouterr().out)
    got = json.loads(out.read_text())
    assert set(got) - {"plots"} == set(want) and got["cells"][0].keys() == want["cells"][0].keys()
    assert summary.keys() == got.keys() and "points" not in summary["cells"][0]
    assert got["cells"][0]["front"] == want["cells"][0]["front"]
    assert got["n_instances"] == want["n_instances"] and got["candidates_per_s"] > 0
    assert len(got["plots"]) == 1


def test_plots_skip_cleanly_without_matplotlib(monkeypatch, tmp_path, capsys):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert t_cli.write_front_plots({"cells": [{}]}, str(tmp_path / "p")) == []
    assert "skipping" in capsys.readouterr().out
