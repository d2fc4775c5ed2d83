"""Batched multi-scenario ALT solving over padded problem ensembles (the JAX
package's `fleet/solve.py`, on PyTorch).

`solve_fleet` pads a heterogeneous list of `Problem`s to a common (V, A, P)
envelope (fleet/pad.py), stacks them, and hands the stack to the shared
round engine (core/engine.py), the same loop the sequential solvers of
core/alt.py run at B=1. For every instance the returned J matches the
sequential solve of the unpadded problem up to float32 rounding.

  * `chunk_size=B` splits large ensembles into fixed-B chunks that all pad
    to the global (V, A) envelope, partition envelope and hop bound; the
    tail chunk is filled with inert repeats of its first instance and
    trimmed on gather. Each chunk exits early on its own.
  * `envelope_cap_gb=G` caps the chunk size so one device's phi-shaped
    `[B, A, K, V, V]` buffers stay under G GB.
  * `trace=True` (default) carries the engine's round trace out as
    `FleetResult.trace`. Apart from it, while `obs.trace` is on, each call
    is one `solve_fleet.call` span, the root of its validate / stack /
    execute / gather spans (and, inside execute, the engine's round and
    phase spans), with the host syncs it made as `host_syncs`; the count
    itself (`device.host_syncs`, obs/sync.py) and per-solve telemetry
    (chunks, pad overhead, rounds against budget) land in
    `obs.metrics.registry` either way. The JAX
    version's `fleet.compile.cold|warm` counters have no counterpart:
    nothing here compiles per padded shape.
  * `shard=True` lays the instance axis over a 1-D fleet mesh of ranks
    (`launch.mesh.make_fleet_mesh`), one process a device under
    `torch.distributed`: every rank calls `solve_fleet` with the same
    problems, pads each chunk's lane count up to a rank multiple with inert
    repeats, and stacks and solves only its own lanes over the chunk's
    global envelope and hop bound. The round loop exits on one flag reduced
    over the mesh a round (core/engine.py), the outputs are `DTensor`s with
    Shard(0), checked by `carries_fleet_sharding`, and the gather
    (`full_tensor()`) gives every rank the same `FleetResult`. On one rank
    it runs unsharded, logged, and `FleetResult.shard` says
    "single-device"; asking for more ranks than the group has raises.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core.alt import ALL_METHODS, linearize, method_kwargs
from ..core.engine import engine_solve
from ..core.flow import objective
from ..core.placement import structured_init
from ..core.structs import Problem, State
from ..device import solve_device
from ..distributed.sharding import (
    FLEET_AXIS,
    carries_fleet_sharding,
    fleet_from_local,
    fleet_lanes,
)
from ..obs.metrics import registry as obs_registry
from ..obs.roundtrace import FleetTrace
from ..obs.sync import count_syncs, sync_span
from ..obs.trace import span, tracer_enabled
from .pad import NU_PAD, fleet_envelope, fleet_part_envelope, stack_problems, unify_hop_bound

METHODS = ("ALT", "OneShot", "CongUnaware", "CoLocated")

logger = logging.getLogger("repro_torch.fleet")

# phi-shaped [A, K, V, V] float32 buffers one engine lane keeps alive at the
# round-body peak (state, best state, next iterate, sweep temporaries):
# the envelope cap's accounting, deliberately conservative.
_PHI_COPIES = 8


def _validate_problems(problems) -> None:
    """Reject inputs that would push NaN/inf through the fixed point, naming
    the instance (and app) at fault. A node with nu <= NU_PAD is dead, so
    an empty live-host set and a dead endpoint of a live app are input
    errors too. Each instance is read to the host: eight copies, counted
    as host syncs at once."""
    started = 0
    try:
        for i, p in enumerate(problems):
            started += 1
            _validate_problem(i, p)
    finally:
        count_syncs(8 * started)


def _validate_problem(i: int, p: Problem) -> None:
    """`_validate_problems` on instance `i`."""
    arrays = {
        k: getattr(grp, k).detach().cpu().numpy()
        for grp, ks in ((p.net, ("adj", "mu", "nu")), (p.apps, ("lam", "L", "w")))
        for k in ks
    }
    for name, arr in arrays.items():
        if not np.isfinite(arr).all():
            raise ValueError(
                f"solve_fleet: instance {i}: non-finite values in {name!r} — refusing to "
                "propagate NaN/inf through the traffic fixed point"
            )
    if (arrays["lam"] < 0).any():
        raise ValueError(f"solve_fleet: instance {i}: negative arrival rate lam")
    if (arrays["mu"] <= 0).any():
        raise ValueError(f"solve_fleet: instance {i}: non-positive link rate mu")
    if (arrays["nu"] <= 0).any():
        raise ValueError(f"solve_fleet: instance {i}: non-positive compute rate nu")
    live = arrays["nu"] > NU_PAD
    lam = arrays["lam"]
    if not live.any():
        a = int(np.argmax(lam > 0)) if (lam > 0).any() else 0
        raise ValueError(
            f"solve_fleet: instance {i}, app {a}, stage 0: live-host set is empty — all "
            f"{live.size} nodes are dead (nu <= NU_PAD = {NU_PAD:g}), no node can host any stage"
        )
    src = p.apps.src.cpu().numpy()
    dst = p.apps.dst.cpu().numpy()
    for a in np.flatnonzero(lam > 0):
        for role, node in (("src", int(src[a])), ("dst", int(dst[a]))):
            if not live[node]:
                raise ValueError(
                    f"solve_fleet: instance {i}, app {int(a)}: {role} node {node} is dead — its "
                    "traffic cannot be " + ("injected" if role == "src" else "absorbed")
                )


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Record of one solve's instance-axis layout decision.

    requested      : the caller passed shard=True
    n_devices      : devices the instance axis was laid over (1 = unsharded)
    batch          : real instances handed to solve_fleet
    padded_batch   : engine lanes actually run, summed over chunks (>= batch;
                     the excess is inert repeats, trimmed on gather)
    reason         : "sharded" | "single-device" | "not-requested"
    output_sharded : every chunk's outputs kept the fleet layout (False
                     whenever n_devices == 1)
    """

    requested: bool
    n_devices: int = 1
    batch: int = 0
    padded_batch: int = 0
    reason: str = "not-requested"
    output_sharded: bool = False

    @property
    def sharded(self) -> bool:
        return self.n_devices > 1

    def describe(self) -> str:
        """One-liner for summaries/CLIs: devices, lane padding, reason."""
        return f"{self.n_devices}dev B={self.batch}->{self.padded_batch} {self.reason}"


@dataclasses.dataclass
class FleetResult:
    """Per-instance results of one batched fleet solve.

    J / J_comm / J_comp : [B] final (best-iterate) objective values
    history             : [B, m_max + 1] outer-iteration J trace, NaN past
                          each instance's freeze point
    iters               : [B] outer iterations applied per instance
    rounds              : round-loop trips executed (max over chunks)
    hosts               : [B, A, P] partition hosts over the fleet envelope
                          (padded apps and phantom partitions hold
                          meaningless-but-harmless indices)
    parts               : [B, A] per-app partition counts
    node_mask/app_mask  : [B, V] / [B, A] validity masks from padding
    shard               : the instance-axis layout decision (`ShardPlan`)
    m_max               : the round budget this solve ran under (0 for
                          CongUnaware, 1 for OneShot)
    trace               : `FleetTrace` of the engine's round diagnostics
                          (None when trace=False, and for CongUnaware)
    state               : the solved stacked `State` (on the device, pad
                          lanes trimmed) when keep_state=True: the warm-start
                          input of the next `solve_fleet`
    """

    method: str
    J: np.ndarray
    J_comm: np.ndarray
    J_comp: np.ndarray
    history: np.ndarray
    iters: np.ndarray
    rounds: int
    hosts: np.ndarray
    parts: np.ndarray
    node_mask: np.ndarray
    app_mask: np.ndarray
    shard: ShardPlan = dataclasses.field(default_factory=lambda: ShardPlan(requested=False))
    m_max: int = 0
    trace: FleetTrace | None = None
    state: State | None = None

    @property
    def n_instances(self) -> int:
        return int(self.J.shape[0])

    def per_instance(self) -> list[dict]:
        out = []
        for b in range(self.n_instances):
            hist = self.history[b]
            n_real = int(self.node_mask[b].sum())
            real = self.app_mask[b] > 0
            parts = self.parts[b][real].astype(int)
            real_hosts = [h[:pa] for h, pa in zip(self.hosts[b][real], parts)]
            # A host past the real-node block would be a solver bug (padded
            # nodes carry a prohibitive marginal): flag it, clamp either way.
            leaked = int(sum(np.sum(h >= n_real) for h in real_hosts))
            row = {
                "J": float(self.J[b]),
                "J_comm": float(self.J_comm[b]),
                "J_comp": float(self.J_comp[b]),
                "history": [float(h) for h in hist[~np.isnan(hist)]],
                "iters": int(self.iters[b]),
                "hosts": [np.minimum(h, n_real - 1).tolist() for h in real_hosts],
                "partitions": int(parts[0]) if len(set(parts.tolist())) <= 1 else parts.tolist(),
            }
            if leaked:
                row["padded_host_leaks"] = leaked
            out.append(row)
        return out

    def summary(self) -> str:
        rounds = f"rounds={self.rounds}"
        if self.m_max:
            tag = " early-exit" if self.rounds < self.m_max else ""
            rounds = f"rounds={self.rounds}/{self.m_max}{tag}"
        churn = f"  churn={self.trace.mean_churn():.2f}/round" if self.trace is not None else ""
        return (
            f"fleet[{self.method}] B={self.n_instances} "
            f"J: min={self.J.min():.3f} med={np.median(self.J):.3f} "
            f"max={self.J.max():.3f}  iters: {self.iters.min()}-{self.iters.max()}"
            f"  {rounds}{churn}  shard[{self.shard.describe()}]"
        )


@torch.no_grad()
def _solve_fleet_congunaware(stacked: Problem, *, solver: str) -> dict:
    """Zero-iteration baseline: linear-cost init scored under true costs."""
    state = structured_init(linearize(stacked))
    J, aux = objective(stacked, state, solver=solver)
    return {
        "J": J,
        "J_comm": aux["J_comm"],
        "J_comp": aux["J_comp"],
        "hosts": state.hosts(),
        "history": J[:, None],
        "iters": torch.zeros(J.shape, dtype=torch.int32, device=J.device),
        "rounds": 0,
        "trace": None,
    }


def _solve_fleet_stacked(
    stacked: Problem,
    *,
    method: str,
    m_max: int,
    t_phi: int,
    alpha: float,
    tol: float,
    patience: int,
    solver: str,
    trace: bool = True,
    keep_state: bool = False,
    block_apps: int = 1,
    lane_chunk: int = 0,
    init_state: State | None = None,
    active0=None,
    group=None,
    device: str | torch.device = "cuda",
) -> dict:
    """Dispatch one stacked batch onto the shared round engine."""
    if method == "CongUnaware":
        solve_device(stacked.device, device)
        return _solve_fleet_congunaware(stacked, solver=solver)
    return engine_solve(
        stacked,
        m_max=1 if method == "OneShot" else m_max,
        t_phi=t_phi,
        alpha=alpha,
        tol=tol,
        patience=patience,
        colocate=method == "CoLocated",
        track_best=method != "OneShot",
        solver=solver,
        trace=trace,
        block_apps=block_apps,
        lane_chunk=lane_chunk,
        keep_state=keep_state,
        init_state=init_state,
        active0=active0,
        group=group,
        device=device,
    )


def _plan_mesh(shard: bool, devices: int | None, dev: torch.device):
    """Decide the instance-axis layout up front, explicitly and logged.
    Returns (mesh or None, n_devices, reason). The ranks are checked before
    any collective (`launch.mesh.fleet_ranks`); the only fallback, a mesh
    of one rank, is surfaced in the plan and the log."""
    if not shard:
        if devices is not None:
            raise ValueError("devices= only applies with shard=True")
        return None, 1, "not-requested"
    from ..launch.mesh import fleet_ranks, make_fleet_mesh

    n_dev = fleet_ranks(devices, device=dev)
    if n_dev < 2:
        logger.warning(
            "solve_fleet(shard=True): only one device in the mesh; running unsharded "
            "(reason=single-device)"
        )
        return None, 1, "single-device"
    return make_fleet_mesh(n_dev, device=dev), n_dev, "sharded"


def _run_chunk(problems, *, envelope, hop_bound, n_parts, round_to, mesh, batch_to, solve_kw, warm=None):
    """Stack one chunk (padding its lane count up to `batch_to`, and on a
    fleet mesh up to a rank multiple, with inert repeats of its first
    instance) and solve it. On a mesh this rank stacks and solves only its
    own lanes, over the chunk's global envelope, partition envelope and hop
    bound, and its outputs come back as DTensors of the fleet layout. `warm`
    is an optional (State, active mask or None) pair covering the real
    instances over the fleet envelope; pad lanes repeat lane 0 and start
    frozen, and a mesh slices the warm state and mask like the problems.
    Returns (engine_out, stacked_info, n_real, n_lanes, outputs_sharded)."""
    real = len(problems)
    target = max(real, batch_to or 0)
    if mesh is not None:
        n_dev = mesh.size()
        target = -(-target // n_dev) * n_dev
    if target > real:
        problems = list(problems) + [problems[0]] * (target - real)
    mine = problems
    if mesh is not None:
        # Every rank pads to the chunk's own envelope, not its lanes'.
        if envelope is None:
            envelope = fleet_envelope(problems, round_to=round_to)
            hop_bound = unify_hop_bound(problems)
            n_parts = fleet_part_envelope(problems)
        mine = problems[fleet_lanes(mesh, target)]
    with span("solve_fleet.stack", batch=target, real=real):
        stacked, info = stack_problems(
            mine, round_to=round_to, envelope=envelope, hop_bound=hop_bound, n_parts=n_parts,
        )
    init_state = active0 = None
    if warm is not None:
        w_state, w_active = warm
        exp = (real,) + tuple(stacked.apps.w.shape[1:]) + (int(stacked.net.adj.shape[-1]),)
        if tuple(w_state.x.shape) != exp:
            raise ValueError(
                f"solve_fleet: warm_start placement shape {tuple(w_state.x.shape)} does not match "
                f"this fleet's stacked envelope {exp} — the (V, A, K) envelope drifted since the "
                "state was produced; re-solve cold"
            )
        if target > real:
            w_state = State(**{
                k: torch.cat([v, v[:1].expand((target - real,) + v.shape[1:])])
                for k, v in (("x", w_state.x), ("phi", w_state.phi))
            })
        dev = stacked.device
        act = (
            torch.ones(real, dtype=torch.bool, device=dev) if w_active is None
            else torch.as_tensor(np.asarray(w_active), device=dev).reshape(real).to(torch.bool)
        )
        active0 = torch.cat([act, torch.zeros(target - real, dtype=torch.bool, device=dev)])
        init_state = w_state
        if mesh is not None:
            lanes = fleet_lanes(mesh, target)
            init_state, active0 = State(x=w_state.x[lanes], phi=w_state.phi[lanes]), active0[lanes]
    group = None if mesh is None else mesh.get_group(FLEET_AXIS)
    with span("solve_fleet.execute", batch=target):
        out = _solve_fleet_stacked(stacked, init_state=init_state, active0=active0, group=group,
                                   **solve_kw)
        if tracer_enabled() and stacked.device.type == "cuda":
            # Only when tracing: the span then covers the device work.
            torch.cuda.synchronize(stacked.device)
    out["parts"] = stacked.apps.parts
    if mesh is None:
        return out, info, real, target, False
    out, info = fleet_from_local(out, mesh), fleet_from_local(info, mesh)
    return out, info, real, target, carries_fleet_sharding(out["J"])


def envelope_cap_chunk(problems, *, round_to: int, n_devices: int, cap_gb: float) -> int:
    """Largest chunk size keeping one device's phi-shaped `[B, A, K, V, V]`
    buffers (`_PHI_COPIES` float32 copies a lane) under `cap_gb` for this
    fleet's (V, A) tier."""
    if cap_gb <= 0:
        raise ValueError(f"envelope_cap_gb must be positive, got {cap_gb}")
    v, a = fleet_envelope(problems, round_to=round_to)
    k_stages = fleet_part_envelope(problems) + 1
    per_lane_bytes = _PHI_COPIES * a * k_stages * v * v * 4
    lanes_per_device = max(1, int(cap_gb * 2**30 // per_lane_bytes))
    return lanes_per_device * max(1, n_devices)


def _full(t):
    """The whole tensor of a fleet-layout DTensor (a gather over the mesh),
    or `t` itself."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _host(t):
    t = _full(t)
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def solve_fleet(
    problems,
    *,
    method: str = "ALT",
    m_max: int = 30,
    t_phi: int = 10,
    alpha: float = 0.5,
    tol: float = 1e-3,
    patience: int = 4,
    round_to: int = 1,
    shard: bool = False,
    devices: int | None = None,
    solver: str = "neumann",
    block_apps: int = 1,
    lane_chunk: int | None = None,
    chunk_size: int | None = None,
    envelope_cap_gb: float | None = None,
    trace: bool = True,
    warm_start: State | None = None,
    warm_active=None,
    keep_state: bool = False,
    validate: bool = True,
    device: str | torch.device = "cuda",
) -> FleetResult:
    """Solve a heterogeneous fleet of problems as one batched computation
    on `device`, which must be where the problems' tensors live.

    problems   : list of `Problem` (mixed sizes; padded internally)
    method     : "ALT" | "OneShot" | "CongUnaware" | "CoLocated", matching
                 the sequential solvers in core/alt.py instance for instance
    round_to   : round the padded (V, A) envelope up to this multiple
    shard      : lay the instance axis over a fleet mesh of the default
                 process group's ranks (module doc); every rank calls this
                 with the same problems and gets the same result. On one
                 rank it runs unsharded, logged, and `FleetResult.shard`
                 says "single-device"
    devices    : cap the mesh to the first N ranks (requires shard=True;
                 more than the group has, or on the card more than the
                 visible GPUs, raises); ranks past it solve nothing and
                 take rank 0's result (with devices=1, rank 0 solves
                 unsharded and every other rank takes its result)
    solver     : "neumann" (hop-capped propagation, default) | "lu"
    block_apps : placement sweep schedule (core/placement.py): 1 = the
                 sequential scan, k > 1 = blocks of k apps, 0 = one block;
                 bitwise the same result for every value
    lane_chunk : engine layout over the instance axis (`engine_solve`):
                 0 or None = the fused batch, k >= 1 = k-lane slices (which
                 a fleet mesh of two or more ranks refuses)
    chunk_size : split ensembles larger than this into fixed-B chunks that
                 share the global envelope and hop bound (tail padded with
                 repeats of its first instance, trimmed); on a mesh it is
                 rounded up to a rank multiple
    envelope_cap_gb : cap the chunk size so one device's phi-shaped buffers
                 stay under this many GB (`envelope_cap_chunk`)
    trace      : carry the round trace out as `FleetResult.trace`; results
                 are bitwise the same either way
    warm_start : a stacked `State` over this fleet's envelope (typically the
                 previous `FleetResult.state`) seeding the engine instead of
                 `structured_init`; single-chunk only
    warm_active: optional [B] bool mask (requires warm_start); False lanes
                 are frozen from round 0 and return the warm state's
                 evaluation
    keep_state : surface the solved stacked `State` as `FleetResult.state`
                 (unsupported for CongUnaware)
    validate   : host-side input validation (`_validate_problems`)
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    problems = list(problems)
    with sync_span("solve_fleet.call", batch=len(problems)):
        if validate:
            with span("solve_fleet.validate", instances=len(problems)):
                _validate_problems(problems)
        if warm_active is not None and warm_start is None:
            raise ValueError("warm_active requires warm_start")
        if warm_start is not None and method == "CongUnaware":
            raise ValueError(
                "warm_start is meaningless for CongUnaware (a zero-iteration baseline that never "
                "runs the engine)"
            )
        if keep_state and method == "CongUnaware":
            raise ValueError("keep_state is unsupported for CongUnaware")
        dev = solve_device(problems[0].device, device) if problems else torch.device(device)
        mesh, n_dev, reason = _plan_mesh(shard, devices, dev)
        if lane_chunk and mesh is not None:
            raise ValueError(
                f"lane_chunk={lane_chunk} is incompatible with a fleet mesh: every rank must run the "
                "fused batch, whose round loop exits on one flag over the mesh — use lane_chunk=0 "
                "(or leave it None) when shard=True"
            )
        solve_kw = dict(
            method=method, m_max=m_max, t_phi=t_phi, alpha=alpha, tol=tol, patience=patience,
            solver=solver, trace=trace, keep_state=keep_state, block_apps=block_apps,
            lane_chunk=lane_chunk or 0, device=device,
        )
        n = len(problems)
        if envelope_cap_gb is not None:
            cap = envelope_cap_chunk(problems, round_to=round_to, n_devices=n_dev,
                                     cap_gb=envelope_cap_gb)
            if chunk_size is None or cap < chunk_size:
                if cap < n:
                    logger.info(
                        "solve_fleet: envelope cap %.3g GB/device limits this (V, A) tier to chunks "
                        "of B=%d (was %s)", envelope_cap_gb, cap, chunk_size,
                    )
                chunk_size = cap
        if mesh is not None and chunk_size is not None and chunk_size % n_dev:
            # Round the chunk itself, so every chunk (not just the tail) runs at
            # a rank multiple.
            chunk_size = -(-chunk_size // n_dev) * n_dev

        warm = None
        if warm_start is not None:
            if chunk_size is not None and n > chunk_size:
                raise ValueError(
                    f"warm_start is single-chunk only: fleet of {n} instances would split into "
                    f"chunks of {chunk_size} — raise chunk_size/envelope_cap_gb or re-solve cold"
                )
            warm = (warm_start, warm_active)

        def solve_and_gather() -> FleetResult:
            chunk_kw = dict(round_to=round_to, mesh=mesh, solve_kw=solve_kw)
            if chunk_size is None or n <= chunk_size:
                outs = [_run_chunk(problems, envelope=None, hop_bound=None, n_parts=None, batch_to=None,
                                   warm=warm, **chunk_kw)]
            else:
                # One global envelope, hop bound and partition envelope: every
                # chunk runs at the same shape.
                envelope = fleet_envelope(problems, round_to=round_to)
                hop_bound = unify_hop_bound(problems)
                part_env = fleet_part_envelope(problems)
                outs = [
                    _run_chunk(problems[i:i + chunk_size], envelope=envelope, hop_bound=hop_bound,
                               n_parts=part_env, batch_to=chunk_size, **chunk_kw)
                    for i in range(0, n, chunk_size)
                ]

            plan = ShardPlan(
                requested=shard, n_devices=n_dev, batch=n,
                padded_batch=sum(lanes for (_, _, _, lanes, _) in outs), reason=reason,
                output_sharded=mesh is not None and all(ok for (*_, ok) in outs),
            )

            with span("solve_fleet.gather", chunks=len(outs)):
                reads = 0  # copies to the host, counted as host syncs at once

                def gather(get):
                    nonlocal reads
                    parts_ = [_host(get(o, i))[:k] for (o, i, k, _, _) in outs]
                    reads += len(parts_)
                    return parts_[0].copy() if len(parts_) == 1 else np.concatenate(parts_)

                def field(name):
                    return gather(lambda o, i: o[name])

                fleet_trace = None
                if all(o.get("trace") is not None for (o, *_) in outs):
                    fleet_trace = FleetTrace(**{
                        k: gather(lambda o, i, k=k: getattr(o["trace"], k))
                        for k in ("J_comm", "J_comp", "moves", "live", "best_round")
                    })
                kept_state = None
                if keep_state:
                    # Pad lanes trimmed per chunk; stays on the device (the next
                    # solve's warm start, not a host export), whole on every rank.
                    states = [State(x=_full(o["state"].x)[:k], phi=_full(o["state"].phi)[:k])
                              for (o, _, k, _, _) in outs]
                    kept_state = states[0] if len(states) == 1 else State(
                        x=torch.cat([s.x for s in states]), phi=torch.cat([s.phi for s in states])
                    )
                result = FleetResult(
                    method=method,
                    J=field("J"),
                    J_comm=field("J_comm"),
                    J_comp=field("J_comp"),
                    history=field("history"),
                    iters=field("iters"),
                    rounds=max(int(o["rounds"]) for (o, *_) in outs),
                    hosts=field("hosts").astype(np.int32),
                    parts=field("parts").astype(np.int32),
                    node_mask=gather(lambda o, i: i.node_mask),
                    app_mask=gather(lambda o, i: i.app_mask),
                    shard=plan,
                    m_max=0 if method == "CongUnaware" else 1 if method == "OneShot" else m_max,
                    trace=fleet_trace,
                    state=kept_state,
                )
                count_syncs(reads)
                return result

        world = dist.get_world_size() if shard and dist.is_initialized() else 1
        if n_dev == world:
            result = solve_and_gather()
        else:
            # Fewer ranks solve than the world holds (devices=N): the ranks past
            # the first N hold no lanes and take rank 0's result.
            box = [solve_and_gather() if dist.get_rank() < n_dev else None]
            dist.broadcast_object_list(box, src=0)
            result = box[0]
            if result.state is not None:
                result.state = State(x=result.state.x.to(dev), phi=result.state.phi.to(dev))

        n_chunks = 1 if chunk_size is None or n <= chunk_size else -(-n // chunk_size)
        plan = result.shard
        obs_registry.counter("fleet.chunks_executed").inc(n_chunks)
        obs_registry.gauge("fleet.rounds_executed").set(result.rounds)
        obs_registry.gauge("fleet.m_max").set(result.m_max)
        obs_registry.gauge("fleet.early_exit_saved_rounds").set(max(0, result.m_max - result.rounds))
        obs_registry.gauge("fleet.pad_overhead_fraction").set(
            0.0 if plan.padded_batch == 0 else (plan.padded_batch - plan.batch) / plan.padded_batch
        )
        return result


def solve_sequential(problems, *, method: str = "ALT", device: str | torch.device = "cuda", **kw) -> list:
    """Reference path: per-instance solving through the same engine at B=1
    on `device`. Kwargs are filtered through `core.alt.METHOD_KWARGS`, one
    shared dict for every method."""
    fn = ALL_METHODS[method]
    return [fn(p, device=device, **method_kwargs(method, kw)) for p in problems]
