"""Frozen numpy copy of the fault-trace generator the faults traffic draws
from, and the per-epoch health that a trace implies.

An event is a dict {epoch, kind, instance, node, edge, scale}:

  node_down / node_up         a node dies and (later) recovers
  link_degrade / link_restore an edge's service rate is scaled by `scale`
                              in (0, 1), both directions
  flash_crowd / flash_end     every app of one network has its arrival
                              rate scaled by `scale` > 1

The draws follow the program's `generate_trace` call for call, so a trace
is event for event the one the program would draw; the benchmark's tests
hold it to that at small sizes. Node kills avoid app endpoints and keep the
live graph connected, so no epoch of a generated trace is unservable.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

NODE_DOWN, NODE_UP = "node_down", "node_up"
LINK_DEGRADE, LINK_RESTORE = "link_degrade", "link_restore"
FLASH_CROWD, FLASH_END = "flash_crowd", "flash_end"


class Health:
    """Cumulative fault state of one network: dead nodes, degraded edges
    ({(u, v): scale}, u < v) and the arrival-rate scale."""

    def __init__(self, down=frozenset(), links=(), rate=1.0):
        self.down = frozenset(down)
        self.links = tuple(sorted(links))
        self.rate = rate

    def key(self):
        return (self.down, self.links, self.rate)

    def __eq__(self, other):
        return isinstance(other, Health) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def apply(self, ev: dict) -> "Health":
        kind = ev["kind"]
        links = dict(self.links)
        if kind == NODE_DOWN:
            return Health(self.down | {ev["node"]}, self.links, self.rate)
        if kind == NODE_UP:
            return Health(self.down - {ev["node"]}, self.links, self.rate)
        if kind == LINK_DEGRADE:
            links[tuple(ev["edge"])] = ev["scale"]
            return Health(self.down, links.items(), self.rate)
        if kind == LINK_RESTORE:
            links.pop(tuple(ev["edge"]), None)
            return Health(self.down, links.items(), self.rate)
        if kind == FLASH_CROWD:
            return Health(self.down, self.links, ev["scale"])
        if kind == FLASH_END:
            return Health(self.down, self.links, 1.0)
        raise ValueError(f"unknown event kind {kind!r}")


def _undirected_edges(adj):
    both = (adj > 0) | (adj.T > 0)
    return [tuple(map(int, e)) for e in np.argwhere(np.triu(both, 1))]


def _connected_without(adj, down) -> bool:
    n = adj.shape[0]
    live = np.ones(n, bool)
    live[list(down)] = False
    idx = np.flatnonzero(live)
    if idx.size == 0:
        return False
    a = ((adj > 0) | (adj.T > 0)).copy()
    a[~live] = False
    a[:, ~live] = False
    seen = np.zeros(n, bool)
    stack = [int(idx[0])]
    seen[idx[0]] = True
    while stack:
        u = stack.pop()
        for v in np.flatnonzero(a[u]):
            if not seen[v]:
                seen[v] = True
                stack.append(int(v))
    return bool(seen[live].all())


def _protected(net: dict) -> set:
    live = net["lam"] > 0
    return set(map(int, net["src"][live])) | set(map(int, net["dst"][live]))


def generate_trace(networks, n_epochs, *, seed=0, node_failures=5, link_degradations=3,
                   flash_crowds=1, min_duration=2, max_duration=6, degrade_range=(0.2, 0.6),
                   crowd_range=(1.5, 3.0)) -> list[dict]:
    """The events of a seeded fault trace over `networks`, in firing order."""
    n_inst = len(networks)
    rng = np.random.RandomState(seed)
    adjs = [net["adj"] for net in networks]
    protected = [_protected(net) for net in networks]
    hi = n_epochs - min_duration
    plan = defaultdict(list)
    for kind, count in ((NODE_DOWN, node_failures), (LINK_DEGRADE, link_degradations),
                        (FLASH_CROWD, flash_crowds)):
        for _ in range(count):
            plan[int(rng.randint(1, hi))].append(kind)

    recoveries = defaultdict(list)
    events = []
    healths = [Health() for _ in range(n_inst)]

    def event(epoch, kind, inst, node=-1, edge=(), scale=1.0):
        return {"epoch": epoch, "kind": kind, "instance": inst, "node": node, "edge": edge,
                "scale": scale}

    def schedule(epoch, kind):
        for inst in map(int, rng.permutation(n_inst)):
            h = healths[inst]
            if kind == NODE_DOWN:
                cand = [v for v in range(adjs[inst].shape[0])
                        if v not in protected[inst] and v not in h.down
                        and _connected_without(adjs[inst], h.down | {v})]
                if not cand:
                    continue
                node = int(cand[rng.randint(len(cand))])
                fire = event(epoch, NODE_DOWN, inst, node=node)
                recover = dict(fire, kind=NODE_UP)
            elif kind == LINK_DEGRADE:
                degraded = {e for e, _ in h.links}
                cand = [e for e in _undirected_edges(adjs[inst])
                        if e not in degraded and e[0] not in h.down and e[1] not in h.down]
                if not cand:
                    continue
                edge = cand[rng.randint(len(cand))]
                fire = event(epoch, LINK_DEGRADE, inst, edge=edge,
                             scale=float(rng.uniform(*degrade_range)))
                recover = dict(fire, kind=LINK_RESTORE, scale=1.0)
            else:
                if h.rate != 1.0:
                    continue
                fire = event(epoch, FLASH_CROWD, inst, scale=float(rng.uniform(*crowd_range)))
                recover = dict(fire, kind=FLASH_END, scale=1.0)
            end = epoch + int(rng.randint(min_duration, max_duration + 1))
            if end < n_epochs:
                recoveries[end].append(recover)
            return fire
        raise ValueError(f"no network can host a {kind} at epoch {epoch} (seed={seed})")

    for epoch in range(n_epochs):
        for recover in recoveries.pop(epoch, []):
            recover = dict(recover, epoch=epoch)
            healths[recover["instance"]] = healths[recover["instance"]].apply(recover)
            events.append(recover)
        for kind in plan.pop(epoch, []):
            fire = schedule(epoch, kind)
            healths[fire["instance"]] = healths[fire["instance"]].apply(fire)
            events.append(fire)
    return events


def healths_by_epoch(events, n_epochs, n_instances) -> list[list[Health]]:
    """The post-event health of every network at every epoch."""
    by_epoch = defaultdict(list)
    for ev in events:
        by_epoch[ev["epoch"]].append(ev)
    healths = [Health() for _ in range(n_instances)]
    out = []
    for epoch in range(n_epochs):
        for ev in by_epoch.get(epoch, []):
            healths[ev["instance"]] = healths[ev["instance"]].apply(ev)
        out.append(list(healths))
    return out

