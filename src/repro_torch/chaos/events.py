"""Seeded fault-trace generation and application (DESIGN.md section 15),
the JAX package's `chaos/events.py` on PyTorch.

A fault trace is a deterministic, replayable sequence of timestamped events
over a fleet of `Problem` instances:

  node_down / node_up         a node dies and (later) recovers
  link_degrade / link_restore an existing edge's service rate mu is scaled
                              down by a factor in (0, 1), both directions
  flash_crowd / flash_end     every app of one instance has its arrival
                              rate lam scaled up (a rate burst)

A dead node is encoded EXACTLY like a padded node: adj rows and columns
zeroed, mu rows and columns set to BIG, nu set to NU_PAD (fleet/pad.py).
The padding inertness contract therefore covers dead nodes: zero incident
traffic means zero D/C contribution, the prohibitive marginal compute cost
1/NU_PAD and the BIG link distances keep the structured init and every
placement sweep off them, and `(I - Phi^T)` stays solvable on the live
block. Perturbation never changes shapes or `hop_bound`.

Schedules are a pure function of (problems, n_epochs, seed), drawn from
numpy's RandomState over host copies of the adjacency and rates in the
JAX package's candidate order, so a trace is event for event the JAX
package's. Node kills are drawn only from nodes that are (a) not a src/dst
endpoint of any live app and (b) whose removal keeps the surviving live
subgraph connected: a generated trace never makes an epoch unservable.
"""
from __future__ import annotations

import dataclasses
import json
from collections import defaultdict

import numpy as np
import torch

from ..core.structs import BIG, Network, Problem
from ..fleet.pad import NU_PAD

NODE_DOWN = "node_down"
NODE_UP = "node_up"
LINK_DEGRADE = "link_degrade"
LINK_RESTORE = "link_restore"
FLASH_CROWD = "flash_crowd"
FLASH_END = "flash_end"

EVENT_KINDS = (
    NODE_DOWN, NODE_UP, LINK_DEGRADE, LINK_RESTORE, FLASH_CROWD, FLASH_END,
)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One timestamped fault or recovery on one instance.

    epoch    : control epoch at which the event fires
    kind     : one of EVENT_KINDS
    instance : fleet index the event applies to
    node     : dead/recovering node (node events; -1 otherwise)
    edge     : undirected (u, v) with u < v (link events; () otherwise)
    scale    : mu multiplier in (0, 1) for link_degrade, lam multiplier
               > 1 for flash_crowd; 1.0 for recoveries
    """

    epoch: int
    kind: str
    instance: int
    node: int = -1
    edge: tuple = ()
    scale: float = 1.0

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}")

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch, "kind": self.kind,
            "instance": self.instance, "node": self.node,
            "edge": list(self.edge), "scale": self.scale,
        }


@dataclasses.dataclass(frozen=True)
class InstanceHealth:
    """Immutable cumulative fault state of one instance.

    Value-equality is the controller's freeze signal: `health == previous`
    means nothing changed since the instance was last solved, so its engine
    lane can start frozen (`warm_active=False`).

    down       : frozenset of dead node indices
    link_scale : sorted tuple of ((u, v), scale) for degraded edges, u < v
    rate_scale : lam multiplier (1.0 = no flash crowd)
    """

    down: frozenset = frozenset()
    link_scale: tuple = ()
    rate_scale: float = 1.0

    @property
    def pristine(self) -> bool:
        return (
            not self.down and not self.link_scale and self.rate_scale == 1.0
        )

    def apply_event(self, ev: FaultEvent) -> "InstanceHealth":
        if ev.kind == NODE_DOWN:
            return dataclasses.replace(self, down=self.down | {ev.node})
        if ev.kind == NODE_UP:
            return dataclasses.replace(self, down=self.down - {ev.node})
        if ev.kind == LINK_DEGRADE:
            scales = dict(self.link_scale)
            scales[tuple(ev.edge)] = ev.scale
            return dataclasses.replace(
                self, link_scale=tuple(sorted(scales.items()))
            )
        if ev.kind == LINK_RESTORE:
            scales = dict(self.link_scale)
            scales.pop(tuple(ev.edge), None)
            return dataclasses.replace(
                self, link_scale=tuple(sorted(scales.items()))
            )
        if ev.kind == FLASH_CROWD:
            return dataclasses.replace(self, rate_scale=ev.scale)
        if ev.kind == FLASH_END:
            return dataclasses.replace(self, rate_scale=1.0)
        raise ValueError(f"unknown event kind {ev.kind!r}")


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    """A replayable event schedule over `n_epochs` x `n_instances`."""

    events: tuple
    n_epochs: int
    n_instances: int

    def counts(self) -> dict:
        out = {k: 0 for k in EVENT_KINDS}
        for ev in self.events:
            out[ev.kind] += 1
        return out

    def timeline(self):
        """Yield (epoch, fired_events, healths) for every epoch in order.

        `healths` is the post-event `InstanceHealth` list — the state the
        controller should perturb and solve against for that epoch."""
        by_epoch = defaultdict(list)
        for ev in self.events:
            by_epoch[ev.epoch].append(ev)
        healths = [InstanceHealth() for _ in range(self.n_instances)]
        for epoch in range(self.n_epochs):
            fired = by_epoch.get(epoch, [])
            for ev in fired:
                healths[ev.instance] = healths[ev.instance].apply_event(ev)
            yield epoch, fired, list(healths)

    def to_json(self) -> str:
        return json.dumps(
            {
                "n_epochs": self.n_epochs,
                "n_instances": self.n_instances,
                "counts": self.counts(),
                "events": [ev.to_dict() for ev in self.events],
            },
            indent=1,
        )

    def save(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json() + "\n")


def _undirected_edges(adj: np.ndarray) -> list:
    both = (adj > 0) | (adj.T > 0)
    return [tuple(map(int, e)) for e in np.argwhere(np.triu(both, 1))]


def _connected_without(adj: np.ndarray, down) -> bool:
    """True iff the live (non-`down`) nodes form one connected component."""
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


def _protected_nodes(problem: Problem) -> set:
    """src/dst endpoints of live apps: killing one makes traffic
    uninjectable/unabsorbable — never scheduled (module doc)."""
    lam = problem.apps.lam.cpu().numpy()
    src = problem.apps.src.cpu().numpy()
    dst = problem.apps.dst.cpu().numpy()
    live = lam > 0
    return set(map(int, src[live])) | set(map(int, dst[live]))


def generate_trace(
    problems,
    n_epochs: int,
    *,
    seed: int = 0,
    node_failures: int = 5,
    link_degradations: int = 3,
    flash_crowds: int = 1,
    min_duration: int = 2,
    max_duration: int = 6,
    degrade_range: tuple = (0.2, 0.6),
    crowd_range: tuple = (1.5, 3.0),
) -> FaultTrace:
    """Schedule a deterministic fault trace over a fleet.

    Exactly `node_failures` node kills, `link_degradations` link
    degradations and `flash_crowds` rate bursts fire at rng-chosen epochs
    in [1, n_epochs - min_duration), each with an rng-chosen duration in
    [min_duration, max_duration] epochs (recovery events past the horizon
    are dropped: the fault simply persists to the end). The whole trace is
    a pure function of (problems, n_epochs, seed).

    Raises if a requested fault cannot be scheduled on ANY instance at its
    chosen epoch (e.g. every killable node is already down) — shrink the
    counts or grow the fleet rather than silently under-delivering chaos.
    """
    n_inst = len(problems)
    if n_inst == 0:
        raise ValueError("generate_trace: empty fleet")
    if n_epochs < min_duration + 2:
        raise ValueError(
            f"generate_trace: n_epochs={n_epochs} too short for faults of "
            f"min_duration={min_duration} (need >= {min_duration + 2})"
        )
    rng = np.random.RandomState(seed)
    adjs = [p.net.adj.cpu().numpy() for p in problems]
    protected = [_protected_nodes(p) for p in problems]

    hi = n_epochs - min_duration
    plan = defaultdict(list)
    for kind, count in (
        (NODE_DOWN, node_failures),
        (LINK_DEGRADE, link_degradations),
        (FLASH_CROWD, flash_crowds),
    ):
        for _ in range(count):
            plan[int(rng.randint(1, hi))].append(kind)

    recoveries = defaultdict(list)
    events = []
    healths = [InstanceHealth() for _ in range(n_inst)]

    def schedule(epoch, kind):
        # Walk instances in rng order until one can host this fault.
        for inst in map(int, rng.permutation(n_inst)):
            h = healths[inst]
            if kind == NODE_DOWN:
                cand = [
                    v
                    for v in range(adjs[inst].shape[0])
                    if v not in protected[inst]
                    and v not in h.down
                    and _connected_without(adjs[inst], h.down | {v})
                ]
                if not cand:
                    continue
                node = int(cand[rng.randint(len(cand))])
                fire = FaultEvent(epoch, NODE_DOWN, inst, node=node)
                recover = dataclasses.replace(fire, kind=NODE_UP)
            elif kind == LINK_DEGRADE:
                degraded = {e for e, _ in h.link_scale}
                cand = [
                    e
                    for e in _undirected_edges(adjs[inst])
                    if e not in degraded
                    and e[0] not in h.down
                    and e[1] not in h.down
                ]
                if not cand:
                    continue
                edge = cand[rng.randint(len(cand))]
                fire = FaultEvent(
                    epoch, LINK_DEGRADE, inst, edge=edge,
                    scale=float(rng.uniform(*degrade_range)),
                )
                recover = dataclasses.replace(
                    fire, kind=LINK_RESTORE, scale=1.0
                )
            else:  # FLASH_CROWD
                if h.rate_scale != 1.0:
                    continue
                fire = FaultEvent(
                    epoch, FLASH_CROWD, inst,
                    scale=float(rng.uniform(*crowd_range)),
                )
                recover = dataclasses.replace(fire, kind=FLASH_END, scale=1.0)
            end = epoch + int(rng.randint(min_duration, max_duration + 1))
            if end < n_epochs:
                recoveries[end].append(recover)
            return fire
        raise ValueError(
            f"generate_trace: no instance can host a {kind} at epoch "
            f"{epoch} (seed={seed}); reduce fault counts or durations"
        )

    for epoch in range(n_epochs):
        for recover in recoveries.pop(epoch, []):
            recover = dataclasses.replace(recover, epoch=epoch)
            healths[recover.instance] = healths[recover.instance].apply_event(
                recover
            )
            events.append(recover)
        for kind in plan.pop(epoch, []):
            fire = schedule(epoch, kind)
            healths[fire.instance] = healths[fire.instance].apply_event(fire)
            events.append(fire)
    return FaultTrace(tuple(events), n_epochs, n_inst)


def apply_health(problem: Problem, health: InstanceHealth):
    """Apply one instance's fault state to its base problem.

    Returns (perturbed_problem, live_mask) where live_mask is a [V] numpy
    float32 validity mask (1.0 = live). Dead nodes get EXACTLY the pad
    encoding (adj rows/cols 0, mu rows/cols BIG, nu = NU_PAD), link
    degradation scales mu on both directions of existing edges, and a flash
    crowd scales every app's lam. The arrays are built in numpy float32 as
    the JAX package builds them, then placed on the problem's device;
    shapes and `hop_bound` are unchanged.
    """
    v = problem.net.n_nodes
    live = np.ones(v, np.float32)
    if health.pristine:
        return problem, live
    dev = problem.device
    adj = problem.net.adj.cpu().numpy().astype(np.float32)
    mu = problem.net.mu.cpu().numpy().astype(np.float32)
    nu = problem.net.nu.cpu().numpy().astype(np.float32)
    for (u, w), scale in health.link_scale:
        for a, b in ((u, w), (w, u)):
            if adj[a, b] > 0:
                mu[a, b] = mu[a, b] * scale
    for d in sorted(health.down):
        live[d] = 0.0
        adj[d, :] = 0.0
        adj[:, d] = 0.0
        mu[d, :] = BIG
        mu[:, d] = BIG
        nu[d] = NU_PAD
    apps = problem.apps
    if health.rate_scale != 1.0:
        lam = apps.lam.cpu().numpy() * np.float32(health.rate_scale)
        apps = dataclasses.replace(apps, lam=torch.tensor(lam, device=dev))
    net = Network(
        adj=torch.tensor(adj, device=dev), mu=torch.tensor(mu, device=dev),
        nu=torch.tensor(nu, device=dev),
    )
    return dataclasses.replace(problem, net=net, apps=apps), live
