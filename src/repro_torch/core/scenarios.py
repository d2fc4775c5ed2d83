"""The paper's four evaluation scenarios (section IV, Table I) and the
synthetic `random_connected` scale family.

  IoT        hierarchical IoT-edge-cloud, strongly heterogeneous (Fig. 3)
  Mesh       regular 5x5 grid
  SmallWorld fixed Watts-Strogatz instance (shortcut-rich irregular)
  GEANT      real backbone-inspired topology

Randomness comes from numpy `RandomState` and, for the small-world graphs,
from the networkx-exact Watts-Strogatz copy in `_graphs.py`, so every array
is bitwise equal to the JAX package's. Arrays are built on the host and
moved to `device` once.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _graphs
from ..device import resolve_device
from .structs import Apps, BIG, CostModel, Network, Problem, with_hop_bound

# Stage packet sizes (L0, L1, L2): first partition acts as local compression.
DEFAULT_L = (2.0, 0.8, 0.3)
# Per-partition workloads: first partition lighter than the second (paper IV).
DEFAULT_W = (0.3, 1.0)


def stage_profile(n_parts: int) -> tuple[tuple, tuple]:
    """(L, w) profiles for a chain of `n_parts` partitions (K = P + 1 stages).

    P = 2 returns the paper's defaults; other depths decay packet sizes
    geometrically from 2.0 to 0.3 and ramp workloads linearly from 0.3 to
    1.0, rescaled to the P = 2 total compute (1.3)."""
    if n_parts < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    if n_parts == 2:
        return DEFAULT_L, DEFAULT_W
    L = np.geomspace(DEFAULT_L[0], DEFAULT_L[-1], n_parts + 1)
    raw = np.linspace(0.3, 1.0, n_parts)
    w = raw * (float(sum(DEFAULT_W)) / raw.sum())
    return tuple(float(x) for x in L), tuple(float(x) for x in w)


def _t(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.int64 if a.dtype.kind in "iu" else torch.float32).to(device)


def build_network(n, und_edges, mu_map, nu, default_mu=10.0, *, device="cuda") -> Network:
    """Assemble a `Network` from an undirected edge list + rate maps: adj from
    the edges, per-direction mu from `mu_map` (else `default_mu`), BIG mu on
    non-edges."""
    dev = resolve_device(device)
    adj = np.zeros((n, n), dtype=np.float32)
    mu = np.full((n, n), 1.0, dtype=np.float32)  # placeholder off-edges
    for (u, v) in und_edges:
        for (i, j) in ((u, v), (v, u)):
            adj[i, j] = 1.0
            mu[i, j] = mu_map.get((i, j), mu_map.get((u, v), default_mu))
    mu = np.where(adj > 0, mu, np.float32(BIG))
    return Network(adj=_t(adj, dev), mu=_t(mu, dev), nu=_t(np.asarray(nu, np.float32), dev))


def gen_apps(
    rng: np.random.RandomState,
    n_apps: int,
    src_pool,
    dst_mode: str,
    n_nodes: int,
    lam_range=(2.0, 4.0),
    L=DEFAULT_L,
    w=DEFAULT_W,
    load_scale: float = 1.0,
    n_parts: int | None = None,
    *,
    device="cuda",
) -> Apps:
    """`n_parts` selects the split depth (stage_profile); None keeps the
    explicitly passed L/w profiles (paper defaults: P = 2)."""
    dev = resolve_device(device)
    if n_parts is not None:
        L, w = stage_profile(n_parts)
    src = rng.choice(src_pool, size=n_apps)
    if dst_mode == "same":
        dst = src.copy()
    else:
        dst = rng.randint(0, n_nodes, size=n_apps)
    lam = rng.uniform(*lam_range, size=n_apps) * load_scale
    Ls = np.tile(np.asarray(L, np.float32), (n_apps, 1))
    ws = np.tile(np.asarray(w, np.float32), (n_apps, 1))
    return Apps(
        src=_t(src.astype(np.int32), dev),
        dst=_t(dst.astype(np.int32), dev),
        lam=_t(lam.astype(np.float32), dev),
        L=_t(Ls, dev),
        w=_t(ws, dev),
    )


def iot(load_scale: float = 1.0, seed: int = 0, cost: CostModel | None = None,
        n_parts: int | None = None, *, device="cuda") -> Problem:
    """17 nodes: 1 cloud (0), 4 edge servers (1-4), 12 IoT devices (5-16)."""
    n = 17
    edges = []
    mu_map = {}
    for e in [(1, 2), (2, 3), (3, 4), (4, 1)]:  # edge ring, medium-fat links
        edges.append(e)
        mu_map[e] = 16.0
    for e_srv in (1, 2, 3, 4):  # edge <-> cloud uplinks
        edges.append((e_srv, 0))
        mu_map[(e_srv, 0)] = 12.0
    for idx, dev_ in enumerate(range(5, 17)):  # dual-homed IoT devices
        e1 = 1 + (idx % 4)
        e2 = 1 + ((idx + 1) % 4)
        for e_srv in (e1, e2):
            edges.append((dev_, e_srv))
            mu_map[(dev_, e_srv)] = 8.0
    nu = np.array([80.0] + [12.0] * 4 + [2.0] * 12, np.float32)
    net = build_network(n, edges, mu_map, nu, device=device)
    rng = np.random.RandomState(seed)
    apps = gen_apps(rng, 20, np.arange(5, 17), "same", n, load_scale=load_scale,
                    n_parts=n_parts, device=device)
    return with_hop_bound(Problem(net=net, apps=apps, cost=cost or CostModel()))


def mesh(load_scale: float = 1.0, seed: int = 1, cost: CostModel | None = None,
         n_parts: int | None = None, *, device="cuda") -> Problem:
    """Regular 5x5 grid, homogeneous mu = nu = 10."""
    side = 5
    n = side * side
    edges = []
    for r in range(side):
        for c in range(side):
            u = r * side + c
            if c + 1 < side:
                edges.append((u, u + 1))
            if r + 1 < side:
                edges.append((u, u + side))
    nu = np.full(n, 10.0, np.float32)
    net = build_network(n, edges, {}, nu, default_mu=10.0, device=device)
    rng = np.random.RandomState(seed)
    apps = gen_apps(rng, 40, np.arange(n), "random", n, load_scale=load_scale,
                    n_parts=n_parts, device=device)
    return with_hop_bound(Problem(net=net, apps=apps, cost=cost or CostModel()))


def smallworld(load_scale: float = 1.0, seed: int = 2, cost: CostModel | None = None,
               n_parts: int | None = None, *, device="cuda") -> Problem:
    """Fixed Watts-Strogatz instance: N=30, k=4, p=0.1 (seeded)."""
    n = 30
    edges = _graphs.edges(_graphs.connected_watts_strogatz_graph(n, 4, 0.1, seed=7))
    nu = np.full(n, 10.0, np.float32)
    net = build_network(n, edges, {}, nu, default_mu=10.0, device=device)
    rng = np.random.RandomState(seed)
    apps = gen_apps(rng, 40, np.arange(n), "random", n, load_scale=load_scale,
                    n_parts=n_parts, device=device)
    return with_hop_bound(Problem(net=net, apps=apps, cost=cost or CostModel()))


# 22-node GEANT-inspired backbone (undirected edge list).
_GEANT_EDGES = [
    (0, 1), (0, 2), (1, 3), (1, 6), (2, 3), (2, 4), (3, 5), (4, 5),
    (4, 7), (5, 8), (6, 8), (6, 9), (7, 8), (7, 11), (8, 10), (9, 10),
    (9, 12), (10, 13), (11, 14), (12, 13), (12, 15), (13, 16), (14, 17),
    (15, 16), (15, 18), (16, 19), (17, 18), (17, 20), (18, 21), (19, 21),
    (20, 21), (3, 10), (8, 13), (5, 16), (2, 9),
]


def geant(load_scale: float = 1.0, seed: int = 3, cost: CostModel | None = None,
          n_parts: int | None = None, *, device="cuda") -> Problem:
    n = 22
    nu = np.full(n, 10.0, np.float32)
    net = build_network(n, _GEANT_EDGES, {}, nu, default_mu=10.0, device=device)
    rng = np.random.RandomState(seed)
    apps = gen_apps(rng, 30, np.arange(n), "random", n, load_scale=load_scale,
                    n_parts=n_parts, device=device)
    return with_hop_bound(Problem(net=net, apps=apps, cost=cost or CostModel()))


def random_connected(
    n: int,
    n_apps: int,
    avg_degree: float = 4.0,
    seed: int = 0,
    load_scale: float = 1.0,
    cost: CostModel | None = None,
    n_parts: int | None = None,
    *,
    device="cuda",
) -> Problem:
    """Synthetic irregular scale family (connected Watts-Strogatz, p = 0.3)."""
    k = max(2, int(round(avg_degree)))
    edges = _graphs.edges(_graphs.connected_watts_strogatz_graph(n, k, 0.3, seed=seed))
    rng = np.random.RandomState(seed + 1)
    nu = rng.uniform(5.0, 15.0, size=n).astype(np.float32)
    mu_map = {e: float(rng.uniform(5.0, 15.0)) for e in edges}
    net = build_network(n, edges, mu_map, nu, device=device)
    apps = gen_apps(rng, n_apps, np.arange(n), "random", n, load_scale=load_scale,
                    n_parts=n_parts, device=device)
    return with_hop_bound(Problem(net=net, apps=apps, cost=cost or CostModel()))


SCENARIOS = {
    "iot": iot,
    "mesh": mesh,
    "smallworld": smallworld,
    "geant": geant,
}
