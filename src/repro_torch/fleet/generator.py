"""Scenario-fleet generation beyond the paper's four fixed topologies
(the JAX package's `fleet/generator.py`, on PyTorch).

Families of instances, each a pure function of one integer seed:

  erdos_renyi       G(n, p) with heterogeneous link/compute rates
  barabasi_albert   preferential attachment (hub-heavy edge cores)
  iot_hierarchy     randomized cloud / edge-ring / device trees in the
                    style of the paper's Fig. 3
  perturbed_geant   degree-preserving rewirings + rate jitter around GEANT

plus `load_grid` / `eta_grid` (one base scenario under a grid of loads or
comm/comp weightings) and `sample_fleet`, which mixes families into one
ensemble. Randomness is numpy `RandomState` and, for the graphs, the
networkx-exact copies in `core/_graphs.py`, so every array is bitwise
equal to the JAX package's. Every function returns an unbatched `Problem`
on `device`; padding and stacking live in `fleet/pad.py`.
"""
from __future__ import annotations

import numpy as np

from ..core import _graphs
from ..core import scenarios as S
from ..core.scenarios import build_network, gen_apps
from ..core.structs import CostModel, Problem, with_hop_bound


def _hetero_rates(rng, edges, n, mu_range=(5.0, 15.0), nu_range=(5.0, 15.0)):
    nu = rng.uniform(*nu_range, size=n).astype(np.float32)
    mu_map = {e: float(rng.uniform(*mu_range)) for e in edges}
    return mu_map, nu


def _problem(n, edges, mu_map, nu, rng, n_apps, src_pool, dst_mode, load_scale, cost, n_parts, device):
    net = build_network(n, edges, mu_map, nu, device=device)
    apps = gen_apps(rng, n_apps, src_pool, dst_mode, n, load_scale=load_scale, n_parts=n_parts,
                    device=device)
    return with_hop_bound(Problem(net=net, apps=apps, cost=cost or CostModel()))


def erdos_renyi(
    n: int,
    n_apps: int,
    p: float | None = None,
    seed: int = 0,
    load_scale: float = 1.0,
    cost: CostModel | None = None,
    n_parts: int | None = None,
    *,
    device="cuda",
) -> Problem:
    """Connected G(n, p); defaults to expected degree ~4. Retries with a
    densified p on the rare disconnected draw so the seed fully determines
    the instance."""
    if p is None:
        p = min(1.0, 4.0 / max(n - 1, 1))
    g = None
    for attempt in range(64):
        cand = _graphs.gnp_random_graph(n, min(1.0, p * (1.15**attempt)), seed=seed + 7919 * attempt)
        if _graphs.is_connected(cand):
            g = cand
            break
    if g is None:  # p has been pushed to ~1 by now
        raise RuntimeError(f"could not draw a connected G({n}, {p})")
    edges = _graphs.edges(g)
    rng = np.random.RandomState(seed + 1)
    mu_map, nu = _hetero_rates(rng, edges, n)
    return _problem(n, edges, mu_map, nu, rng, n_apps, np.arange(n), "random", load_scale, cost,
                    n_parts, device)


def barabasi_albert(
    n: int,
    n_apps: int,
    m_attach: int = 2,
    seed: int = 0,
    load_scale: float = 1.0,
    cost: CostModel | None = None,
    n_parts: int | None = None,
    *,
    device="cuda",
) -> Problem:
    """Preferential attachment: connected by construction, hub-heavy; hubs
    get proportionally stronger compute."""
    g = _graphs.barabasi_albert_graph(n, max(1, m_attach), seed=seed)
    edges = _graphs.edges(g)
    rng = np.random.RandomState(seed + 1)
    mu_map, nu = _hetero_rates(rng, edges, n)
    deg = np.asarray([d for _, d in sorted(_graphs.degree(g))], np.float32)
    nu = (nu * (0.5 + deg / deg.mean())).astype(np.float32)
    return _problem(n, edges, mu_map, nu, rng, n_apps, np.arange(n), "random", load_scale, cost,
                    n_parts, device)


def iot_hierarchy(
    n_edge: int | None = None,
    devices_per_edge: int | None = None,
    n_apps: int | None = None,
    seed: int = 0,
    load_scale: float = 1.0,
    cost: CostModel | None = None,
    n_parts: int | None = None,
    *,
    device="cuda",
) -> Problem:
    """Randomized cloud / edge-ring / IoT-device hierarchy (Fig.-3 style).

    Node 0 is the cloud; nodes 1..E are ring-connected edge servers with
    cloud uplinks; devices hang off 1-2 randomly chosen edge servers. Apps
    source (and sink) at devices."""
    rng = np.random.RandomState(seed)
    e = int(n_edge if n_edge is not None else rng.randint(3, 7))
    dpe = int(devices_per_edge if devices_per_edge is not None else rng.randint(2, 5))
    n_dev = e * dpe
    n = 1 + e + n_dev
    edges, mu_map = [], {}
    for i in range(e):  # edge ring
        a, b = 1 + i, 1 + ((i + 1) % e)
        edges.append((a, b))
        mu_map[(a, b)] = float(rng.uniform(12.0, 20.0))
    for srv in range(1, e + 1):  # cloud uplinks
        edges.append((srv, 0))
        mu_map[(srv, 0)] = float(rng.uniform(9.0, 15.0))
    first_dev = 1 + e
    for d in range(n_dev):  # dual-homed devices on weak links
        dev = first_dev + d
        homes = {1 + (d % e)}
        if rng.rand() < 0.7:
            homes.add(1 + rng.randint(e))
        for srv in sorted(homes):
            edges.append((dev, srv))
            mu_map[(dev, srv)] = float(rng.uniform(5.0, 10.0))
    nu = np.concatenate([
        rng.uniform(60.0, 100.0, size=1),  # cloud
        rng.uniform(9.0, 15.0, size=e),  # edge servers
        rng.uniform(1.5, 3.0, size=n_dev),  # devices
    ]).astype(np.float32)
    a = int(n_apps if n_apps is not None else max(4, int(1.5 * n_dev)))
    return _problem(n, edges, mu_map, nu, rng, a, np.arange(first_dev, n), "same", load_scale, cost,
                    n_parts, device)


def perturbed_geant(
    seed: int = 0,
    rewire_frac: float = 0.15,
    rate_jitter: float = 0.25,
    n_apps: int = 30,
    load_scale: float = 1.0,
    cost: CostModel | None = None,
    n_parts: int | None = None,
    *,
    device="cuda",
) -> Problem:
    """Degree-preserving rewiring + multiplicative rate jitter around GEANT:
    isolates wiring robustness from capacity and degree effects."""
    g = _graphs.graph_from_edges(S._GEANT_EDGES)
    n = len(g)
    nswap = max(1, int(rewire_frac * len(_graphs.edges(g))))
    _graphs.connected_double_edge_swap(g, nswap, seed=seed + 13)
    edges = _graphs.edges(g)
    rng = np.random.RandomState(seed + 1)
    jit = lambda size: rng.uniform(1.0 - rate_jitter, 1.0 + rate_jitter, size)  # noqa: E731
    nu = (10.0 * jit(n)).astype(np.float32)
    mu_map = {e: float(10.0 * jit(1)[0]) for e in edges}
    return _problem(n, edges, mu_map, nu, rng, n_apps, np.arange(n), "random", load_scale, cost,
                    n_parts, device)


FAMILIES = {
    "erdos_renyi": erdos_renyi,
    "barabasi_albert": barabasi_albert,
    "iot_hierarchy": iot_hierarchy,
    "perturbed_geant": perturbed_geant,
}


def load_grid(base, scales, cost: CostModel | None = None, **kw) -> list[Problem]:
    """One fleet = one scenario under a grid of load scales (Fig-4 axis)."""
    return [base(load_scale=float(f), cost=cost, **kw) for f in scales]


def eta_grid(base, etas, **kw) -> list[Problem]:
    """One fleet = one scenario under a grid of comm/comp weightings
    (Fig-5 axis): J_eta = eta * J_comm + (1 - eta) * J_comp."""
    return [base(cost=CostModel(w_comm=float(eta), w_comp=1.0 - float(eta)), **kw) for eta in etas]


def sample_fleet(
    n_instances: int,
    families=None,
    seed: int = 0,
    n_range=(12, 28),
    apps_range=(6, 20),
    load_range=(0.5, 1.2),
    cost: CostModel | None = None,
    partitions=None,
    *,
    device="cuda",
) -> list[Problem]:
    """A mixed ensemble of `n_instances` distinct problems.

    Families are cycled round-robin; sizes, loads and family seeds come
    from one master RandomState, so the fleet is a pure function of `seed`.
    `partitions` (e.g. (1, 2, 3)) cycles split depths across instances;
    None keeps the paper's P = 2."""
    if families is None:
        families = list(FAMILIES)
    unknown = [f for f in families if f not in FAMILIES]
    if unknown:
        raise ValueError(f"unknown families {unknown}; expected a subset of {sorted(FAMILIES)}")
    if partitions is not None and not all(int(p) >= 1 for p in partitions):
        raise ValueError(f"partitions must all be >= 1, got {partitions}")
    master = np.random.RandomState(seed)
    fleet = []
    for i in range(n_instances):
        fam = families[i % len(families)]
        sub = int(master.randint(0, 2**31 - 1))
        load = float(master.uniform(*load_range))
        kw = dict(seed=sub, load_scale=load, cost=cost, device=device,
                  n_parts=None if partitions is None else int(partitions[i % len(partitions)]))
        if fam in ("iot_hierarchy", "perturbed_geant"):
            fleet.append(FAMILIES[fam](**kw))
        else:
            n = int(master.randint(n_range[0], n_range[1] + 1))
            a = int(master.randint(apps_range[0], apps_range[1] + 1))
            fleet.append(FAMILIES[fam](n, a, **kw))
    return fleet
