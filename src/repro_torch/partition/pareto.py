"""Split-point Pareto search over the model zoo (DESIGN.md section 17);
the JAX package's `partition/pareto.py` on PyTorch.

The paper's headline finding is that *split flexibility* dominates in
IoT-edge-cloud settings — but the placement optimizer alone only chooses
WHERE to put fixed cuts. This module searches the split axis itself, the
Pareto-front analysis of "Where to Split?" (arXiv 2601.08025) built on the
fleet engine:

  1. `enumerate_candidates` (partition/profile.py) emits every cut point
     x P in {1..4} for each zoo architecture, with per-cut L and exact
     per-layer-type w;
  2. each candidate becomes one `Problem` per (topology, load, eta) cell —
     the scenario's own traffic matrix with every app running that
     candidate's chain — and ALL candidates across ALL cells are solved as
     ONE batched `solve_fleet` call (mixed-P phantom-stage padding from
     DESIGN.md section 13 absorbs the ragged depths);
  3. per (architecture, topology, load) cell, the solved placements are
     scored on three axes — latency (J_comm + J_comp, the unweighted total
     delay), compute (J_comp), and egress (bytes/s actually shipped across
     links: lam_a * sum_k L_k over stages whose endpoints differ) — and
     `pareto_front` filters dominated candidates.

Candidate profiles are normalized per architecture so every candidate of
one arch is comparable and lands in the scenarios' operating range: bytes
scale so the largest stage packet of the arch's default profile equals the
paper's L0 = 2.0, FLOPs scale so the total per-request work equals the
paper's 1.3 (total work is split-invariant, so this is one constant per
arch, not per candidate).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs import ZOO, get_config
from ..core.scenarios import DEFAULT_L, DEFAULT_W, SCENARIOS
from ..core.structs import CostModel, Problem
from ..device import resolve_device
from ..fleet import solve_fleet
from ..obs.metrics import registry as obs_registry
from ..obs.trace import span
from .profile import ArchProfile, apps_from_profiles, enumerate_candidates, profile_arch


def pareto_front(points) -> np.ndarray:
    """Boolean mask of non-dominated rows (every objective minimized).

    Row i is dominated iff some row j is <= i in every column and < i in at
    least one; duplicated points survive together (neither strictly
    improves on the other). O(N^2) with vectorized inner sweeps — cells are
    hundreds of points, not millions."""
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2:
        raise ValueError(
            f"pareto_front: expected [N, D] objectives, got shape {pts.shape}"
        )
    n = pts.shape[0]
    keep = np.ones(n, bool)
    for i in range(n):
        dominated = (pts <= pts[i]).all(axis=1) & (pts < pts[i]).any(axis=1)
        if dominated.any():
            keep[i] = False
    return keep


@dataclasses.dataclass(frozen=True)
class _ArchCandidates:
    """One architecture's enumerated candidate set + normalization."""

    profiles: tuple[ArchProfile, ...]
    n_possible: int
    byte_scale: float
    flop_scale: float


def _normalized_candidates(
    arch: str, *, seq_len, n_out_tokens, parts, max_per_p
) -> _ArchCandidates:
    cfg = get_config(arch)
    profiles, n_possible = enumerate_candidates(
        cfg, seq_len=seq_len, n_out_tokens=n_out_tokens, parts=parts,
        max_per_p=max_per_p,
    )
    base = profile_arch(cfg, seq_len=seq_len, n_out_tokens=n_out_tokens)
    return _ArchCandidates(
        profiles=tuple(profiles),
        n_possible=n_possible,
        byte_scale=DEFAULT_L[0] / max(base.L_bytes),
        flop_scale=float(sum(DEFAULT_W)) / sum(base.w_flops),
    )


def _egress_bytes_per_s(src, dst, lam, L_row, hosts_row) -> float:
    """Link bytes/s of one solved instance: every stage whose consecutive
    endpoints differ ships its packet across the network."""
    total = 0.0
    for a in range(len(src)):
        endpoints = [int(src[a]), *map(int, hosts_row[a]), int(dst[a])]
        for k in range(len(endpoints) - 1):
            if endpoints[k] != endpoints[k + 1]:
                total += float(lam[a]) * float(L_row[k])
    return total


def candidate_fleet(cand: dict, topologies, loads, etas, device) -> tuple[list, list]:
    """One `Problem` per (topology, load, architecture, eta, candidate), in
    that nesting order: the scenario's own network and traffic with every
    app running the candidate's chain, on `device`. `cand` maps each
    architecture to its `_normalized_candidates`. Returns (problems, index),
    index holding each problem's cell, cut set and scaled stage sizes."""
    problems: list[Problem] = []
    index: list[dict] = []
    for topo in topologies:
        for load in loads:
            base = SCENARIOS[topo](load_scale=load, device=device)
            src = base.apps.src.cpu().numpy()
            dst = base.apps.dst.cpu().numpy()
            lam = base.apps.lam.cpu().numpy()
            for arch, ac in cand.items():
                for eta in etas:
                    cost = CostModel(w_comm=eta, w_comp=1.0 - eta)
                    for prof in ac.profiles:
                        apps = apps_from_profiles(
                            [prof] * len(src), src, dst, lam,
                            byte_scale=ac.byte_scale, flop_scale=ac.flop_scale, device=device,
                        )
                        problems.append(
                            Problem(net=base.net, apps=apps, cost=cost, hop_bound=base.hop_bound)
                        )
                        index.append({
                            "arch": arch,
                            "topology": topo,
                            "load": load,
                            "eta": eta,
                            "splits": list(prof.splits),
                            "parts": prof.n_parts,
                            "L_row": [b * ac.byte_scale for b in prof.L_bytes],
                            # Host copies of the app endpoints and rates,
                            # for the egress score.
                            "host_apps": (src, dst, lam),
                        })
    return problems, index


def sweep_zoo(
    archs=None,
    topologies=("iot", "mesh"),
    loads=(1.0,),
    etas=(0.5,),
    *,
    parts=(1, 2, 3, 4),
    max_per_p=16,
    seq_len=256,
    n_out_tokens=32,
    method="ALT",
    m_max=8,
    t_phi=5,
    round_to=8,
    shard=False,
    devices=None,
    chunk_size=None,
    envelope_cap_gb=2.0,
    solver="neumann",
    validate=True,
    device: str | torch.device = "cuda",
) -> dict:
    """Enumerate, solve, and Pareto-filter split candidates for the zoo.

    Returns a JSON-ready report: one cell per (architecture, topology,
    load), each holding every candidate evaluation (splits, parts, eta, J,
    latency/compute/egress) and the indices of its dominated-point-filtered
    Pareto front. The entire sweep is ONE `solve_fleet` call; `chunk_size`
    / `envelope_cap_gb` (default 2 GB) bound the compiled envelope exactly
    as any other fleet. Every problem is built, and the sweep solved, on
    `device`."""
    dev = resolve_device(device)
    archs = tuple(archs) if archs else ZOO
    topologies = tuple(topologies)
    loads = tuple(float(x) for x in loads)
    etas = tuple(float(x) for x in etas)
    for t in topologies:
        if t not in SCENARIOS:
            raise ValueError(
                f"sweep_zoo: unknown topology {t!r}; "
                f"available: {tuple(SCENARIOS)}"
            )
    for eta in etas:
        if not 0.0 <= eta <= 1.0:
            raise ValueError(f"sweep_zoo: eta must be in [0, 1], got {eta}")

    with span("pareto.enumerate", archs=len(archs)):
        cand = {
            a: _normalized_candidates(
                a, seq_len=seq_len, n_out_tokens=n_out_tokens, parts=parts,
                max_per_p=max_per_p,
            )
            for a in archs
        }
    n_enumerated = sum(len(c.profiles) for c in cand.values())
    n_possible = sum(c.n_possible for c in cand.values())
    obs_registry.counter("pareto.cut_sets_possible").inc(n_possible)
    obs_registry.counter("pareto.cut_sets_dropped").inc(
        n_possible - n_enumerated
    )

    with span("pareto.build", cells=len(archs) * len(topologies) * len(loads)):
        problems, index = candidate_fleet(cand, topologies, loads, etas, dev)

    obs_registry.counter("pareto.candidates_solved").inc(len(problems))
    with span("pareto.solve", instances=len(problems)):
        res = solve_fleet(
            problems,
            method=method,
            m_max=m_max,
            t_phi=t_phi,
            round_to=round_to,
            shard=shard,
            devices=devices,
            chunk_size=chunk_size,
            envelope_cap_gb=envelope_cap_gb,
            solver=solver,
            trace=False,
            validate=validate,
            device=dev,
        )

    with span("pareto.extract", instances=len(problems)):
        rows = res.per_instance()
        cells: dict[tuple, list[dict]] = {}
        for rec, row in zip(index, rows):
            src, dst, lam = rec["host_apps"]
            point = {
                "splits": rec["splits"],
                "parts": rec["parts"],
                "eta": rec["eta"],
                "J": row["J"],
                "latency": row["J_comm"] + row["J_comp"],
                "compute": row["J_comp"],
                "egress": _egress_bytes_per_s(
                    src, dst, lam, rec["L_row"], row["hosts"]
                ),
            }
            key = (rec["arch"], rec["topology"], rec["load"])
            cells.setdefault(key, []).append(point)

        out_cells = []
        for (arch, topo, load), points in sorted(cells.items()):
            objectives = np.array(
                [[p["latency"], p["compute"], p["egress"]] for p in points]
            )
            mask = pareto_front(objectives)
            for p, on in zip(points, mask):
                p["on_front"] = bool(on)
            front = np.flatnonzero(mask).tolist()
            obs_registry.histogram("pareto.front_size").observe(len(front))
            out_cells.append(
                {
                    "arch": arch,
                    "topology": topo,
                    "load": load,
                    "n_points": len(points),
                    "front_size": len(front),
                    "n_dominated": len(points) - len(front),
                    "front": front,
                    "points": points,
                }
            )
    obs_registry.gauge("pareto.cells").set(len(out_cells))

    return {
        "archs": list(archs),
        "topologies": list(topologies),
        "loads": list(loads),
        "etas": list(etas),
        "parts": list(parts),
        "max_per_p": max_per_p,
        "seq_len": seq_len,
        "method": method,
        "n_instances": len(problems),
        "candidates_per_cell": (
            0 if not out_cells
            else min(c["n_points"] for c in out_cells)
        ),
        # Mixed-P candidates solved per (topology, load) cell — the batch
        # the acceptance gate counts (all archs x etas land in one cell).
        "candidates_per_topo_load": (
            len(problems) // max(1, len(topologies) * len(loads))
        ),
        "cut_sets_possible": n_possible,
        "cut_sets_dropped": n_possible - n_enumerated,
        "rounds": res.rounds,
        "shard": res.shard.describe(),
        "pad_overhead_fraction": (
            0.0 if res.shard.padded_batch == 0
            else (res.shard.padded_batch - res.shard.batch)
            / res.shard.padded_batch
        ),
        "cells": out_cells,
    }


def check_fronts(report: dict) -> None:
    """Hard-gate a sweep report (the CI `pareto` job's assertion):

      * every cell has a non-empty front of finite points;
      * dominated-point filtering actually filtered (n_dominated > 0);
      * the recorded front is exactly the re-verified non-dominated set.

    Raises ValueError naming the first offending cell."""
    if not report["cells"]:
        raise ValueError("check_fronts: report has no cells")
    for cell in report["cells"]:
        name = f"{cell['arch']}/{cell['topology']}/load={cell['load']}"
        pts = np.array(
            [
                [p["latency"], p["compute"], p["egress"]]
                for p in cell["points"]
            ]
        )
        if not np.isfinite(pts).all():
            raise ValueError(
                f"check_fronts: cell {name} has non-finite objectives"
            )
        if not cell["front"]:
            raise ValueError(f"check_fronts: cell {name} has an empty front")
        if cell["n_dominated"] <= 0:
            raise ValueError(
                f"check_fronts: cell {name} filtered no dominated points "
                f"({cell['n_points']} points all mutually non-dominated — "
                "the candidate set is degenerate)"
            )
        expect = np.flatnonzero(pareto_front(pts)).tolist()
        if sorted(cell["front"]) != expect:
            raise ValueError(
                f"check_fronts: cell {name} front {cell['front']} does not "
                f"match the re-verified non-dominated set {expect}"
            )


def fronts_agree(ref: dict, got: dict, rtol: float) -> list:
    """Whether two reports' fronts of one cell agree up to near-ties: every
    index on one front only needs a partner on the other front whose
    latency, compute and egress agree with its own within `rtol` in both
    reports. Such points tie in exact arithmetic (e.g. cut sets that put
    every partition on one host), so rounding may order them either way.
    Returns those indices; raises ValueError if one lacks a partner."""
    fa, fb = set(ref["front"]), set(got["front"])

    def objectives(cell, i):
        return np.array([cell["points"][i][k] for k in ("latency", "compute", "egress")])

    swapped = sorted(fa ^ fb)
    for i in swapped:
        other = fb if i in fa else fa
        if not any(
            all(np.allclose(objectives(c, i), objectives(c, j), rtol=rtol, atol=0) for c in (ref, got))
            for j in other
        ):
            raise ValueError(
                f"fronts_agree: {ref['arch']}/{ref['topology']}/load={ref['load']}: front "
                f"{got['front']} vs {ref['front']}, index {i} has no near-tie partner"
            )
    return swapped
