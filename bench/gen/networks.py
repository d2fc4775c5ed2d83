"""Frozen numpy copies of the network and application builders that the
benchmark's configurations draw from: the paper's `random_connected` scale
family and the four fleet families of `sample_fleet` (G(n, p),
Barabasi-Albert, the IoT cloud / edge / device tree of the paper's Fig. 3,
GEANT rewired).

Every builder returns one network as a dict of numpy arrays, keyed as the
solver's structures are:

  adj [n, n] float32 {0, 1}   mu [n, n] float32 (BIG off-edge)   nu [n] float32
  src, dst [A] int64   lam [A] float32   L [A, K] float32   w [A, P] float32
  parts [A] int64 (every app runs all P partitions)

The draws follow the program's generators call for call, so the arrays are
bitwise the ones `repro_torch.fleet.sample_fleet` and
`repro_torch.core.scenarios.random_connected` build; the benchmark's tests
hold them to that at small sizes.
"""
from __future__ import annotations

import numpy as np

from . import graphs

BIG = 1e18
DEFAULT_L = (2.0, 0.8, 0.3)
DEFAULT_W = (0.3, 1.0)

# 22-node GEANT-inspired backbone (undirected edge list).
GEANT_EDGES = [
    (0, 1), (0, 2), (1, 3), (1, 6), (2, 3), (2, 4), (3, 5), (4, 5),
    (4, 7), (5, 8), (6, 8), (6, 9), (7, 8), (7, 11), (8, 10), (9, 10),
    (9, 12), (10, 13), (11, 14), (12, 13), (12, 15), (13, 16), (14, 17),
    (15, 16), (15, 18), (16, 19), (17, 18), (17, 20), (18, 21), (19, 21),
    (20, 21), (3, 10), (8, 13), (5, 16), (2, 9),
]


def stage_profile(n_parts: int) -> tuple[tuple, tuple]:
    """(L, w) of a chain of `n_parts` partitions: the paper's defaults at
    P = 2; otherwise packet sizes decay geometrically from 2.0 to 0.3 and
    workloads ramp from 0.3 to 1.0, rescaled to the P = 2 total of 1.3."""
    if n_parts == 2:
        return DEFAULT_L, DEFAULT_W
    L = np.geomspace(DEFAULT_L[0], DEFAULT_L[-1], n_parts + 1)
    raw = np.linspace(0.3, 1.0, n_parts)
    w = raw * (float(sum(DEFAULT_W)) / raw.sum())
    return tuple(float(x) for x in L), tuple(float(x) for x in w)


def network_arrays(n, und_edges, mu_map, nu, default_mu=10.0) -> dict:
    adj = np.zeros((n, n), dtype=np.float32)
    mu = np.full((n, n), 1.0, dtype=np.float32)
    for (u, v) in und_edges:
        for (i, j) in ((u, v), (v, u)):
            adj[i, j] = 1.0
            mu[i, j] = mu_map.get((i, j), mu_map.get((u, v), default_mu))
    mu = np.where(adj > 0, mu, np.float32(BIG)).astype(np.float32)
    return {"adj": adj, "mu": mu, "nu": np.asarray(nu, np.float32)}


def app_arrays(rng, n_apps, src_pool, dst_mode, n_nodes, load_scale=1.0, n_parts=None,
               lam_range=(2.0, 4.0)) -> dict:
    L, w = stage_profile(2 if n_parts is None else n_parts)
    src = rng.choice(src_pool, size=n_apps)
    dst = src.copy() if dst_mode == "same" else rng.randint(0, n_nodes, size=n_apps)
    lam = rng.uniform(*lam_range, size=n_apps) * load_scale
    return {
        "src": src.astype(np.int32).astype(np.int64),
        "dst": dst.astype(np.int32).astype(np.int64),
        "lam": lam.astype(np.float32),
        "L": np.tile(np.asarray(L, np.float32), (n_apps, 1)),
        "w": np.tile(np.asarray(w, np.float32), (n_apps, 1)),
        "parts": np.full(n_apps, len(w), np.int64),
    }


def _hetero_rates(rng, edges, n):
    nu = rng.uniform(5.0, 15.0, size=n).astype(np.float32)
    mu_map = {e: float(rng.uniform(5.0, 15.0)) for e in edges}
    return mu_map, nu


def _network(n, edges, mu_map, nu, rng, n_apps, src_pool, dst_mode, load_scale, n_parts):
    out = network_arrays(n, edges, mu_map, nu)
    out.update(app_arrays(rng, n_apps, src_pool, dst_mode, n, load_scale, n_parts))
    return out


def erdos_renyi(n, n_apps, seed=0, load_scale=1.0, n_parts=None):
    p = min(1.0, 4.0 / max(n - 1, 1))
    g = None
    for attempt in range(64):
        cand = graphs.gnp_random_graph(n, min(1.0, p * (1.15**attempt)), seed=seed + 7919 * attempt)
        if graphs.is_connected(cand):
            g = cand
            break
    if g is None:
        raise RuntimeError(f"could not draw a connected G({n}, {p})")
    edges = graphs.edges(g)
    rng = np.random.RandomState(seed + 1)
    mu_map, nu = _hetero_rates(rng, edges, n)
    return _network(n, edges, mu_map, nu, rng, n_apps, np.arange(n), "random", load_scale, n_parts)


def barabasi_albert(n, n_apps, seed=0, load_scale=1.0, n_parts=None):
    g = graphs.barabasi_albert_graph(n, 2, seed=seed)
    edges = graphs.edges(g)
    rng = np.random.RandomState(seed + 1)
    mu_map, nu = _hetero_rates(rng, edges, n)
    deg = np.asarray([d for _, d in sorted(graphs.degree(g))], np.float32)
    nu = (nu * (0.5 + deg / deg.mean())).astype(np.float32)
    return _network(n, edges, mu_map, nu, rng, n_apps, np.arange(n), "random", load_scale, n_parts)


def iot_hierarchy(seed=0, load_scale=1.0, n_parts=None):
    rng = np.random.RandomState(seed)
    e = int(rng.randint(3, 7))
    dpe = int(rng.randint(2, 5))
    n_dev = e * dpe
    n = 1 + e + n_dev
    edges, mu_map = [], {}
    for i in range(e):
        a, b = 1 + i, 1 + ((i + 1) % e)
        edges.append((a, b))
        mu_map[(a, b)] = float(rng.uniform(12.0, 20.0))
    for srv in range(1, e + 1):
        edges.append((srv, 0))
        mu_map[(srv, 0)] = float(rng.uniform(9.0, 15.0))
    first_dev = 1 + e
    for d in range(n_dev):
        dev = first_dev + d
        homes = {1 + (d % e)}
        if rng.rand() < 0.7:
            homes.add(1 + rng.randint(e))
        for srv in sorted(homes):
            edges.append((dev, srv))
            mu_map[(dev, srv)] = float(rng.uniform(5.0, 10.0))
    nu = np.concatenate([
        rng.uniform(60.0, 100.0, size=1),
        rng.uniform(9.0, 15.0, size=e),
        rng.uniform(1.5, 3.0, size=n_dev),
    ]).astype(np.float32)
    a = max(4, int(1.5 * n_dev))
    return _network(n, edges, mu_map, nu, rng, a, np.arange(first_dev, n), "same", load_scale, n_parts)


def perturbed_geant(seed=0, load_scale=1.0, n_parts=None, rewire_frac=0.15, rate_jitter=0.25,
                    n_apps=30):
    g = graphs.graph_from_edges(GEANT_EDGES)
    n = len(g)
    nswap = max(1, int(rewire_frac * len(graphs.edges(g))))
    graphs.connected_double_edge_swap(g, nswap, seed=seed + 13)
    edges = graphs.edges(g)
    rng = np.random.RandomState(seed + 1)

    def jit(size):
        return rng.uniform(1.0 - rate_jitter, 1.0 + rate_jitter, size)

    nu = (10.0 * jit(n)).astype(np.float32)
    mu_map = {e: float(10.0 * jit(1)[0]) for e in edges}
    return _network(n, edges, mu_map, nu, rng, n_apps, np.arange(n), "random", load_scale, n_parts)


FAMILIES = ("erdos_renyi", "barabasi_albert", "iot_hierarchy", "perturbed_geant")


def sample_fleet(n_instances, seed=0, n_range=(12, 28), apps_range=(6, 20), load_range=(0.5, 1.2),
                 partitions=None, families=FAMILIES) -> list[dict]:
    """A mixed fleet: families round-robin, sizes, loads and family seeds
    from one master RandomState, split depths cycling through `partitions`
    (None keeps P = 2)."""
    master = np.random.RandomState(seed)
    fleet = []
    for i in range(n_instances):
        fam = families[i % len(families)]
        sub = int(master.randint(0, 2**31 - 1))
        load = float(master.uniform(*load_range))
        kw = dict(seed=sub, load_scale=load,
                  n_parts=None if partitions is None else int(partitions[i % len(partitions)]))
        if fam == "iot_hierarchy":
            fleet.append(iot_hierarchy(**kw))
        elif fam == "perturbed_geant":
            fleet.append(perturbed_geant(**kw))
        else:
            n = int(master.randint(n_range[0], n_range[1] + 1))
            a = int(master.randint(apps_range[0], apps_range[1] + 1))
            fleet.append((erdos_renyi if fam == "erdos_renyi" else barabasi_albert)(n, a, **kw))
    return fleet


def random_connected(n, n_apps, avg_degree=4.0, seed=0, load_scale=1.0, n_parts=None) -> dict:
    """Synthetic irregular scale family: connected Watts-Strogatz, p = 0.3."""
    k = max(2, int(round(avg_degree)))
    edges = graphs.edges(graphs.connected_watts_strogatz_graph(n, k, 0.3, seed=seed))
    rng = np.random.RandomState(seed + 1)
    nu = rng.uniform(5.0, 15.0, size=n).astype(np.float32)
    mu_map = {e: float(rng.uniform(5.0, 15.0)) for e in edges}
    out = network_arrays(n, edges, mu_map, nu)
    out.update(app_arrays(rng, n_apps, np.arange(n), "random", n, load_scale, n_parts))
    return out


def scale_tier(n_networks, n, n_apps, seed=1, n_parts=None) -> list[dict]:
    """`n_networks` x `random_connected(n, n_apps, seed=seed + b)`, the
    scale benchmark's tier layout (which starts at seed 1)."""
    return [random_connected(n, n_apps, seed=seed + b, n_parts=n_parts)
            for b in range(n_networks)]


GENERATORS = {"sample_fleet": sample_fleet, "scale_tier": scale_tier}


def build(config: dict, seed: int) -> list[dict]:
    """The networks of a configuration file's `fleet` entry, drawn from
    `seed` (below 2**31): the entry fixes the families and the ranges of
    sizes and loads, the seed draws each network within them."""
    spec = dict(config["fleet"])
    gen = GENERATORS[spec.pop("generator")]
    for k, v in list(spec.items()):
        if isinstance(v, list):
            spec[k] = tuple(v)
    return gen(**spec, seed=seed)
