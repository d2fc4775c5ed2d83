"""Pure-Python copies of the networkx 3.6.1 graph generators the scenario
and fleet constructors use: `connected_watts_strogatz_graph`,
`gnp_random_graph`, `barabasi_albert_graph`, `connected_double_edge_swap`
and `is_connected`.

The machine with the GPU has no networkx, and the scenario and fleet arrays
must come out bitwise equal to the JAX package's, which builds its graphs
with networkx. Each copy draws from `random.Random(seed)` in networkx's
exact order and keeps the graph as an insertion-ordered dict of adjacency
dicts (node -> {neighbour: None}), mutated the way `nx.Graph` mutates its
own: `edges(g)` then reproduces `list(G.edges())`, the order in which the
constructors draw one `mu` per edge. Node order is insertion order too
(`graph_from_edges` adds nodes as the edge list first names them, as
`nx.Graph(edge_list)` does), which `degree` and the edge swap's degree
distribution follow.
"""
from __future__ import annotations

import bisect
import itertools
import math
import random

Graph = dict  # node -> {neighbour: None}, both insertion-ordered


def empty_graph(n: int) -> Graph:
    return {u: {} for u in range(n)}


def add_edge(g: Graph, u, v) -> None:
    """`nx.Graph.add_edge`: an existing edge keeps its place in both dicts."""
    g.setdefault(u, {})
    g.setdefault(v, {})
    g[u][v] = None
    g[v][u] = None


def remove_edge(g: Graph, u, v) -> None:
    del g[u][v]
    if u != v:
        del g[v][u]


def graph_from_edges(edge_list) -> Graph:
    """`nx.Graph(edge_list)`: nodes in order of first appearance."""
    g: Graph = {}
    for u, v in edge_list:
        add_edge(g, u, v)
    return g


def edges(g: Graph) -> list[tuple[int, int]]:
    """Undirected edges in networkx `Graph.edges()` order."""
    out, seen = [], set()
    for u, nbrs in g.items():
        for v in nbrs:
            if v not in seen:
                out.append((u, v))
        seen.add(u)
    return out


def degree(g: Graph) -> list[tuple[int, int]]:
    """`list(G.degree())`: (node, degree) in node order (no self-loops)."""
    return [(u, len(nbrs)) for u, nbrs in g.items()]


def _reachable(g: Graph, source) -> set:
    seen = {source}
    frontier = [source]
    while frontier:
        nxt = []
        for u in frontier:
            for v in g[u]:
                if v not in seen:
                    seen.add(v)
                    nxt.append(v)
        frontier = nxt
    return seen


def is_connected(g: Graph) -> bool:
    if not g:
        raise ValueError("connectivity is undefined for the null graph")
    return len(_reachable(g, next(iter(g)))) == len(g)


def _watts_strogatz(n: int, k: int, p: float, rng: random.Random) -> Graph:
    if k > n:
        raise ValueError("k>n, choose smaller k or larger n")
    g = empty_graph(n)
    if k == n:  # complete graph
        for u, v in itertools.combinations(range(n), 2):
            add_edge(g, u, v)
        return g
    nodes = list(range(n))
    for j in range(1, k // 2 + 1):
        for u, v in zip(nodes, nodes[j:] + nodes[0:j]):
            add_edge(g, u, v)
    for j in range(1, k // 2 + 1):
        for u, v in zip(nodes, nodes[j:] + nodes[0:j]):
            if rng.random() < p:
                w = rng.choice(nodes)
                # No self-loops or multiple edges.
                while w == u or w in g[u]:
                    w = rng.choice(nodes)
                    if len(g[u]) >= n - 1:
                        break  # skip this rewiring
                else:
                    remove_edge(g, u, v)
                    add_edge(g, u, w)
    return g


def connected_watts_strogatz_graph(
    n: int, k: int, p: float, tries: int = 100, seed: int | None = None
) -> Graph:
    """A connected Watts-Strogatz graph (networkx semantics)."""
    rng = random.Random(seed)
    for _ in range(tries):
        g = _watts_strogatz(n, k, p, rng)
        if is_connected(g):
            return g
    raise RuntimeError("Maximum number of tries exceeded")


def gnp_random_graph(n: int, p: float, seed: int | None = None) -> Graph:
    """G(n, p): one draw per node pair, in `combinations(range(n), 2)` order."""
    rng = random.Random(seed)
    g = empty_graph(n)
    if p >= 1:
        for u, v in itertools.combinations(range(n), 2):
            add_edge(g, u, v)
        return g
    if p <= 0:
        return g
    for u, v in itertools.combinations(range(n), 2):
        if rng.random() < p:
            add_edge(g, u, v)
    return g


def barabasi_albert_graph(n: int, m: int, seed: int | None = None) -> Graph:
    """Preferential attachment from a star on m + 1 nodes. The m targets of
    each new node are a Python set, iterated in set order as networkx does."""
    if m < 1 or m >= n:
        raise ValueError(f"Barabasi-Albert network must have m >= 1 and m < n, m = {m}, n = {n}")
    rng = random.Random(seed)
    g = empty_graph(m + 1)
    for node in range(1, m + 1):
        add_edge(g, 0, node)
    repeated = [u for u, d in degree(g) for _ in range(d)]
    source = len(g)
    while source < n:
        targets = set()
        while len(targets) < m:
            targets.add(rng.choice(repeated))
        for t in targets:
            add_edge(g, source, t)
        repeated.extend(targets)
        repeated.extend([source] * m)
        source += 1
    return g


def connected_double_edge_swap(
    g: Graph, nswap: int = 1, _window_threshold: int = 3, seed: int | None = None
) -> int:
    """Degree-preserving double-edge swaps that keep `g` connected, in place;
    returns the number of swaps kept. Windows of swaps grow while the graph
    stays connected; a small window checks each swap and undoes it at once,
    a large one checks the whole window and undoes it in reverse."""
    if not is_connected(g):
        raise ValueError("Graph not connected")
    if len(g) < 4:
        raise ValueError("Graph has fewer than four nodes.")
    rng = random.Random(seed)
    n = 0
    swapcount = 0
    dk = [u for u, _ in degree(g)]
    total, cdf = 0.0, [0.0]
    for _, d in degree(g):
        total += d
        cdf.append(total)
    cdf = [c / total for c in cdf]
    window = 1
    while n < nswap:
        wcount = 0
        swapped = []
        small = window < _window_threshold
        fail = False
        while wcount < window and n < nswap:
            draws = [rng.random() for _ in range(2)]
            ui, xi = (bisect.bisect_left(cdf, s) - 1 for s in draws)
            if ui == xi:
                continue
            u, x = dk[ui], dk[xi]
            v = rng.choice(list(g[u]))
            y = rng.choice(list(g[x]))
            if v == y:
                continue
            if x not in g[u] and y not in g[v]:
                remove_edge(g, u, v)
                remove_edge(g, x, y)
                add_edge(g, u, x)
                add_edge(g, v, y)
                swapped.append((u, v, x, y))
                swapcount += 1
            n += 1
            if not small:
                wcount += 1
            elif v in _reachable(g, u):
                wcount += 1
            else:
                add_edge(g, u, v)
                add_edge(g, x, y)
                remove_edge(g, u, x)
                remove_edge(g, v, y)
                swapcount -= 1
                fail = True
        if small:
            window = math.ceil(window / 2) if fail else window + 1
        elif is_connected(g):
            window += 1
        else:
            while swapped:
                u, v, x, y = swapped.pop()
                add_edge(g, u, v)
                add_edge(g, x, y)
                remove_edge(g, u, x)
                remove_edge(g, v, y)
                swapcount -= 1
            window = math.ceil(window / 2)
    return swapcount
