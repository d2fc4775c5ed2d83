"""Pure-Python copy of `networkx.connected_watts_strogatz_graph`.

The machine with the GPU has no networkx, and the scenario arrays must come
out bitwise equal to the JAX package's, which builds its small-world graphs
with networkx. This copy draws from `random.Random(seed)` in networkx's
exact order (ring, then rewiring outer loop over neighbour distance, inner
loop over nodes, `tries` retries until connected) and keeps the graph as
insertion-ordered adjacency dicts, so `edges(g)` reproduces the order of
`list(G.edges())`: `random_connected` draws one `mu` per edge in that order.
"""
from __future__ import annotations

import random


def _watts_strogatz(n: int, k: int, p: float, rng: random.Random) -> list[dict]:
    if k > n:
        raise ValueError("k>n, choose smaller k or larger n")
    adj = [dict() for _ in range(n)]

    def add(u, v):
        adj[u][v] = None
        adj[v][u] = None

    if k == n:  # complete graph
        for u in range(n):
            for v in range(u + 1, n):
                add(u, v)
        return adj
    nodes = list(range(n))
    for j in range(1, k // 2 + 1):
        for u, v in zip(nodes, nodes[j:] + nodes[0:j]):
            add(u, v)
    for j in range(1, k // 2 + 1):
        for u, v in zip(nodes, nodes[j:] + nodes[0:j]):
            if rng.random() < p:
                w = rng.choice(nodes)
                # No self-loops or multiple edges.
                while w == u or w in adj[u]:
                    w = rng.choice(nodes)
                    if len(adj[u]) >= n - 1:
                        break  # skip this rewiring
                else:
                    del adj[u][v]
                    del adj[v][u]
                    add(u, w)
    return adj


def _is_connected(adj: list[dict]) -> bool:
    if not adj:
        raise ValueError("connectivity is undefined for the null graph")
    seen = {0}
    frontier = [0]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if v not in seen:
                    seen.add(v)
                    nxt.append(v)
        frontier = nxt
    return len(seen) == len(adj)


def edges(adj: list[dict]) -> list[tuple[int, int]]:
    """Undirected edges in networkx `Graph.edges()` order."""
    out, seen = [], set()
    for u, nbrs in enumerate(adj):
        for v in nbrs:
            if v not in seen:
                out.append((u, v))
        seen.add(u)
    return out


def connected_watts_strogatz_graph(
    n: int, k: int, p: float, tries: int = 100, seed: int | None = None
) -> list[dict]:
    """Adjacency dicts of a connected Watts-Strogatz graph (networkx semantics)."""
    rng = random.Random(seed)
    for _ in range(tries):
        adj = _watts_strogatz(n, k, p, rng)
        if _is_connected(adj):
            return adj
    raise RuntimeError("Maximum number of tries exceeded")
