"""Epoch controller: fault trace -> repair -> warm re-solve, with a
degradation ladder that guarantees every epoch ends with a servable
placement (DESIGN.md section 15); the JAX package's `launch/control.py`
on PyTorch.

Per epoch:
  1. advance the fault trace and apply each instance's `InstanceHealth`
     to its base problem (`chaos.apply_health` — dead nodes become padded
     nodes, degraded links get scaled mu, flash crowds scale lam);
  2. repair the previous epoch's placement (`chaos.repair_fleet`): evict
     partitions from dead hosts, rebuild phi around dead nodes — the
     repaired state is both the warm start AND the degradation floor;
  3. warm re-solve with freeze masks: only instances whose health changed
     since their last solve burn rounds (`solve_fleet(warm_start=...,
     warm_active=changed)`); an event-free epoch costs one init eval.

Degradation ladder on non-finite J, infeasible placement, or an exception:
warm -> cold re-solve from scratch -> CoLocated (the always-feasible
single-host baseline) -> carry the repaired previous placement unchanged.
Escalation honors a soft per-epoch timeout and optional exponential
backoff. Every rung records through obs.metrics (`control.*` counters,
recovery-latency histogram) and obs.trace spans, and the whole run
serializes to JSON.

CLI (without `--device cpu` it runs on the GPU, and raises without one;
the flags are the JAX CLI's less `--use-pallas` / `--interpret`):
  PYTHONPATH=src python -m repro_torch.launch.control --instances 8 \\
      --epochs 50 --seed 11 --m-max 8 --json-out control.json \\
      --events-out events.json --assert-feasible
  PYTHONPATH=src python -m repro_torch.launch.control --instances 2 \\
      --epochs 5 --m-max 2 --t-phi 2 --device cpu --trace-out spans.jsonl
  PYTHONPATH=src python -m repro_torch.obs.validate spans.jsonl

`--shard` behaves as `solve_fleet(shard=True)`: every rank of the process
group runs the loop and each solve lays the instances over the fleet mesh;
one rank runs unsharded. Under a launcher, one process a device:
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.control --instances 8 \\
      --epochs 5 --m-max 2 --t-phi 2 --shard --device cpu
(gloo on the CPU, NCCL on GPUs); only rank 0 prints and writes files.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time

import numpy as np
import torch

from ..chaos import (
    FaultTrace,
    InstanceHealth,
    apply_health,
    generate_trace,
    refresh_apsp0,
    repair_fleet,
)
from ..core.structs import State, hop_bound_cache
from ..device import resolve_device, solve_device
from ..fleet import FAMILIES, sample_fleet, solve_fleet
from ..fleet.pad import fleet_envelope, fleet_part_envelope, unify_hop_bound
from ..fleet.solve import _plan_mesh
from .mesh import init_from_env
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..obs.trace import span

logger = logging.getLogger("repro_torch.control")


@dataclasses.dataclass
class EpochReport:
    """What one control epoch did and what it cost.

    mode     : "cold" (first epoch / post-fallback) or "warm"
    outcome  : "ok" — the first-choice solve was accepted;
               "cold-retry" / "colocated" — a ladder rung caught it;
               "carry" — every rung failed, the repaired previous placement
               was carried unchanged (still servable: repair guarantees no
               dead hosts)
    perturbed: instances whose health changed this epoch
    rounds   : engine round-loop trips of the accepted solve (0 for carry)
    cold_rounds : rounds of the comparison solve-from-scratch when the
               controller ran one (compare_cold; event epochs only)
    recovery_s : wall time from epoch start to accepted placement, only for
               epochs where at least one fault/recovery fired
    """

    epoch: int
    mode: str
    outcome: str
    attempts: int
    perturbed: int
    events: list
    rounds: int
    J_median: float
    finite: bool
    feasible: bool
    wall_s: float
    recovery_s: float | None = None
    cold_rounds: int | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ControlResult:
    """The epochs' reports and the trace's event counts; `state` is the
    stacked placement carried out of the last epoch, on the device."""

    reports: list
    n_instances: int
    counts: dict
    wall_s: float
    state: State | None = None

    def summary(self) -> dict:
        n = len(self.reports)
        rec = [r.recovery_s for r in self.reports if r.recovery_s is not None]
        warm_ok = [r for r in self.reports if r.mode == "warm" and r.outcome == "ok"]
        warm_event = [r for r in warm_ok if r.perturbed > 0]
        cold_cmp = [r.cold_rounds for r in self.reports if r.cold_rounds is not None]
        out = {
            "epochs": n,
            "instances": self.n_instances,
            "epochs_per_s": round(n / max(self.wall_s, 1e-9), 4),
            "wall_s": round(self.wall_s, 3),
            "feasible_fraction": sum(r.feasible for r in self.reports) / max(n, 1),
            "infeasible_epochs": sum(not r.feasible for r in self.reports),
            "nonfinite_epochs": sum(not r.finite for r in self.reports),
            "fallback_epochs": sum(r.outcome != "ok" for r in self.reports),
            "fallback_rate": sum(r.outcome != "ok" for r in self.reports) / max(n, 1),
            "p50_recovery_latency_s": round(float(np.percentile(rec, 50)), 4) if rec else 0.0,
            "p95_recovery_latency_s": round(float(np.percentile(rec, 95)), 4) if rec else 0.0,
            "warm_epochs": len(warm_ok),
            # Mean engine trips of warm event-epochs against the matching
            # solve-from-scratch comparison runs.
            "warm_rounds_executed": (
                round(float(np.mean([r.rounds for r in warm_event])), 3) if warm_event else 0.0
            ),
            "events": dict(self.counts),
        }
        if cold_cmp:
            out["cold_rounds_executed"] = round(float(np.mean(cold_cmp)), 3)
        return out


def _feasible_hosts(hosts, parts_list, live_masks) -> bool:
    """No live partition of any app may sit on a dead (or padded) node."""
    hosts = np.asarray(hosts)
    for b, live in enumerate(live_masks):
        live = np.asarray(live) > 0
        n_real = live.size
        parts = np.asarray(parts_list[b])
        for a in range(parts.size):
            hs = hosts[b, a, : int(parts[a])]
            if (hs >= n_real).any():
                return False
            if not live[hs].all():
                return False
    return True


def run_control(
    fleet,
    trace: FaultTrace | None = None,
    *,
    epochs: int | None = None,
    seed: int = 0,
    m_max: int = 8,
    t_phi: int = 5,
    alpha: float = 0.5,
    tol: float = 1e-3,
    patience: int = 4,
    solver: str = "neumann",
    block_apps: int = 1,
    lane_chunk: int | None = None,
    round_to: int = 8,
    shard: bool = False,
    devices: int | None = None,
    timeout_s: float | None = None,
    backoff_s: float = 0.0,
    compare_cold: bool = False,
    verify_hop_bound: bool = False,
    verify_apsp0: bool = False,
    trace_kwargs: dict | None = None,
    device: str | torch.device = "cuda",
) -> ControlResult:
    """Run the fault-injection control loop over a fleet (module doc).

    fleet        : base (unperturbed) `Problem` list, all on `device`
    trace        : a pre-generated `FaultTrace`; None generates one from
                   (fleet, epochs, seed, **trace_kwargs)
    timeout_s    : soft per-epoch budget — once exceeded, the ladder stops
                   escalating and carries the repaired placement
    backoff_s    : base of the exponential retry backoff between rungs
    compare_cold : on each warm event-epoch, also run an (unused) cold
                   solve-from-scratch on the same perturbed problems and
                   record its rounds — the warm-start efficiency baseline
    verify_hop_bound : per epoch, re-derive every instance's hop closure
                   from scratch and assert the incremental `HopBoundCache`
                   refresh matches it bitwise (the section 16 exactness
                   contract)
    verify_apsp0 : per warm epoch whose zero-load APSP came from the cache,
                   recompute it from scratch and assert the `Apsp0Cache`
                   pair the repair consumed matches it bitwise
    block_apps / lane_chunk : forwarded to every `solve_fleet` rung — a
                   name of the JAX package's sweep schedule (the port runs
                   the sequential scan for every value) and the engine's
                   lane layout (both bitwise-invariant; see fleet/solve.py)
    shard / devices : as `solve_fleet`; the ranks are checked before the
                   first epoch, so a mesh wider than the process group
                   raises instead of sending every epoch down the ladder.
                   Every rank of the process group runs this loop on the
                   same fleet and trace, and every solve's result is whole
                   on each rank
    device       : where the fleet lives and every solve runs

    The envelope and the hop bound are pinned from the base fleet, and the
    per-epoch `hop_bound_cache` maintenance is the cheap incremental
    tracker feeding the `control.hop_bound.*` metrics: most epochs leave
    the adjacency untouched (degradations scale mu, flash crowds scale lam)
    and cost one on-device compare an instance; node churn epochs re-close
    warm in one or two squaring sweeps. The JAX package solves every epoch
    under the pinned bound, exact there because its XLA Neumann cap is
    floored at V + 1. The port's cap is the kernel contract, bound + 32
    hops with no floor, so once an epoch's tracked diameter + 2 passes the
    pinned bound (`control.hop_bound.exceeds_pinned`), that epoch and the
    rest of the run are solved under the highest bound tracked so far: a
    warm start carries the longer paths of the epochs it came from. The
    per-element freeze makes the extra hops free where the series has
    converged, and eager PyTorch recompiles nothing for them.
    """
    base = list(fleet)
    n_inst = len(base)
    dev = solve_device(base[0].device, device) if base else resolve_device(device)
    _plan_mesh(shard, devices, dev)
    if trace is None:
        if epochs is None:
            raise ValueError("run_control: pass either trace= or epochs=")
        trace = generate_trace(base, epochs, seed=seed, **(trace_kwargs or {}))
    if trace.n_instances != n_inst:
        raise ValueError(
            f"run_control: trace covers {trace.n_instances} instances, fleet has {n_inst}"
        )
    # Pin the stacked envelope from the BASE fleet: perturbation never
    # changes shapes, so every epoch's repair + solve agree on it and the
    # carried State stays shape-stable (warm_start would raise otherwise).
    envelope = fleet_envelope(base, round_to=round_to)
    part_env = fleet_part_envelope(base)
    hop_bound = unify_hop_bound(base)
    solve_hb = hop_bound
    parts_list = [p.apps.parts.cpu().numpy() for p in base]

    solve_common = dict(
        m_max=m_max, t_phi=t_phi, alpha=alpha, tol=tol, patience=patience,
        round_to=round_to, shard=shard, devices=devices, solver=solver,
        block_apps=block_apps, lane_chunk=lane_chunk, keep_state=True,
        # The controller re-validates shape-stable perturbations of an
        # already-validated base fleet every epoch; keep the checks on —
        # they are exactly the NaN firewall this loop exists for.
        validate=True, device=dev,
    )
    env_kw = dict(
        round_to=round_to, envelope=envelope, hop_bound=hop_bound, n_parts=part_env, device=dev,
    )

    reg = obs_metrics.registry
    reports: list = []
    prev_state = None
    prev_health = [InstanceHealth() for _ in range(n_inst)]
    force_all_active = False
    hop_caches = [None] * n_inst
    apsp0 = None
    t_run = time.time()

    for epoch, fired, healths in trace.timeline():
        t0 = time.time()
        with span("control.epoch", epoch=epoch, events=len(fired)):
            with span("control.chaos", epoch=epoch):
                pairs = [apply_health(p, h) for p, h in zip(base, healths)]
                probs = [pr for pr, _ in pairs]
                masks = [m for _, m in pairs]
            with span("control.hop_bound", epoch=epoch):
                hop_caches = [
                    hop_bound_cache(pr.net, hc, device=dev) for pr, hc in zip(probs, hop_caches)
                ]
                if verify_hop_bound:
                    for i, (pr, hc) in enumerate(zip(probs, hop_caches)):
                        scratch = hop_bound_cache(pr.net, None, device=dev)
                        if not torch.equal(hc.dist, scratch.dist):
                            raise AssertionError(
                                f"control: epoch {epoch} instance {i}: incremental hop-bound "
                                "closure diverged from the from-scratch solve (warm bound "
                                f"{hc.hop_bound}, scratch {scratch.hop_bound})"
                            )
                tracked = max(c.hop_bound for c in hop_caches)
                reg.gauge("control.hop_bound.max").set(tracked)
                reg.counter("control.hop_bound.warm_sweeps").inc(
                    sum(c.sweeps for c in hop_caches if c.sweeps > 0)
                )
                reg.counter("control.hop_bound.unchanged").inc(
                    sum(1 for c in hop_caches if c.sweeps == 0)
                )
                if tracked > hop_bound:
                    reg.counter("control.hop_bound.exceeds_pinned").inc()
                # The Neumann cap is the bound + 32 with no V + 1 floor: solve
                # under the highest bound tracked so far, or a path stretched
                # past the pinned bound's slack (in this epoch's graph, or in
                # the warm start carried from an earlier one) is truncated.
                solve_hb = max(solve_hb, tracked)
                if solve_hb > hop_bound:
                    probs = [dataclasses.replace(pr, hop_bound=solve_hb) for pr in probs]
            changed = np.array([h != ph for h, ph in zip(healths, prev_health)], dtype=bool)
            repaired = None
            if prev_state is not None:
                with span("control.repair", epoch=epoch):
                    apsp0 = refresh_apsp0(probs, apsp0, **env_kw)
                    reg.counter(
                        "control.apsp0.hits" if apsp0.reused else "control.apsp0.misses"
                    ).inc()
                    if verify_apsp0 and apsp0.reused:
                        scratch = refresh_apsp0(probs, None, **env_kw)
                        if not (torch.equal(apsp0.dist, scratch.dist)
                                and torch.equal(apsp0.nexthop, scratch.nexthop)):
                            raise AssertionError(
                                f"control: epoch {epoch}: cached zero-load APSP diverged from "
                                "the from-scratch solve (the Apsp0Cache key let a changed "
                                "input through)"
                            )
                    repaired = repair_fleet(probs, prev_state, masks, apsp0=apsp0, **env_kw)

            mode = "warm" if repaired is not None else "cold"
            ladder = []
            if repaired is not None:
                active = np.ones(n_inst, bool) if force_all_active else changed
                ladder.append(
                    ("warm", dict(method="ALT", warm_start=repaired, warm_active=active))
                )
            ladder.append(("cold", dict(method="ALT")))
            ladder.append(("colocated", dict(method="CoLocated")))

            result = None
            accepted_rung = None
            attempts = 0
            for rung, (name, extra) in enumerate(ladder):
                if attempts > 0 and timeout_s is not None and time.time() - t0 > timeout_s:
                    logger.warning(
                        "control: epoch %d over budget (%.2fs > %.2fs); carrying repaired "
                        "placement", epoch, time.time() - t0, timeout_s,
                    )
                    break
                if attempts > 0 and backoff_s > 0:
                    time.sleep(backoff_s * (2 ** (attempts - 1)))
                attempts += 1
                try:
                    with span("control.solve", epoch=epoch, rung=name):
                        # The gather of J to the host waits for the device,
                        # so recovery latency includes device completion.
                        r = solve_fleet(probs, **extra, **solve_common)
                except Exception:
                    logger.exception("control: epoch %d %s solve raised", epoch, name)
                    continue
                if not np.isfinite(r.J).all():
                    logger.warning(
                        "control: epoch %d %s solve returned non-finite J; escalating", epoch, name,
                    )
                    continue
                if not _feasible_hosts(r.hosts, parts_list, masks):
                    logger.warning(
                        "control: epoch %d %s solve placed on a dead host; escalating", epoch, name,
                    )
                    continue
                result = r
                accepted_rung = rung
                break

            perturbed = int(changed.sum())
            if result is not None:
                outcome = (
                    "ok" if accepted_rung == 0
                    else "cold-retry" if ladder[accepted_rung][0] == "cold"
                    else "colocated"
                )
                prev_state = result.state
                rounds = int(result.rounds)
                j_med = float(np.median(result.J))
                finite = True
                feasible = True
            else:
                # Degradation floor: the repaired previous placement (the
                # first epoch always reaches a rung: cold and CoLocated ran).
                outcome = "carry"
                rounds = 0
                j_med = float("nan")
                finite = False
                feasible = repaired is not None and _feasible_hosts(
                    repaired.hosts().cpu().numpy(), parts_list, masks
                )
                if repaired is not None:
                    prev_state = repaired

            cold_rounds = None
            if compare_cold and result is not None and mode == "warm" and perturbed > 0:
                with span("control.compare_cold", epoch=epoch):
                    rc = solve_fleet(
                        probs, method="ALT",
                        **{k: v for k, v in solve_common.items() if k != "keep_state"},
                    )
                cold_rounds = int(rc.rounds)

            wall = time.time() - t0
            report = EpochReport(
                epoch=epoch,
                mode=mode,
                outcome=outcome,
                attempts=attempts,
                perturbed=perturbed,
                events=[ev.to_dict() for ev in fired],
                rounds=rounds,
                J_median=j_med,
                finite=finite,
                feasible=feasible,
                wall_s=round(wall, 4),
                recovery_s=round(wall, 4) if fired else None,
                cold_rounds=cold_rounds,
            )
            reports.append(report)
            prev_health = list(healths)
            force_all_active = outcome != "ok"

            reg.counter("control.epochs").inc()
            reg.counter(f"control.outcome.{outcome}").inc()
            reg.counter(f"control.mode.{mode}").inc()
            if not feasible:
                reg.counter("control.infeasible_epochs").inc()
            if fired:
                reg.histogram("control.recovery_latency_s").observe(wall)
            reg.gauge("control.last_rounds").set(rounds)

    return ControlResult(
        reports=reports, n_instances=n_inst, counts=trace.counts(), wall_s=time.time() - t_run,
        state=prev_state,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="fault-injection control loop over a sampled fleet")
    ap.add_argument("--families", default="iot_hierarchy",
                    help=f"comma-separated generator families ({','.join(FAMILIES)})")
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--node-failures", type=int, default=5)
    ap.add_argument("--link-degradations", type=int, default=3)
    ap.add_argument("--flash-crowds", type=int, default=1)
    ap.add_argument("--m-max", type=int, default=8)
    ap.add_argument("--t-phi", type=int, default=5)
    ap.add_argument("--round-to", type=int, default=8)
    ap.add_argument("--solver", choices=("neumann", "lu"), default="neumann")
    ap.add_argument("--verify-hop-bound", action="store_true",
                    help="assert the incremental per-epoch hop-bound cache matches a from-scratch "
                    "closure bitwise (exactness gate)")
    ap.add_argument("--verify-apsp0", action="store_true",
                    help="assert the cached zero-load APSP behind each warm epoch's repair matches "
                    "a from-scratch solve bitwise (exactness gate)")
    ap.add_argument("--block-apps", type=int, default=1,
                    help="the JAX package's placement sweep schedule, forwarded to every solve rung "
                    "(1 = sequential scan, k > 1 = blocked, 0 = one block; bitwise-invariant); "
                    "the port runs the sequential scan for every value")
    ap.add_argument("--lane-chunk", type=int, default=None,
                    help="engine layout over the instance axis (0 or unset = the fused batch, "
                    "k >= 1 = k-lane slices; the same result)")
    ap.add_argument("--shard", action="store_true",
                    help="lay the instance axis over the launcher's ranks (one rank: unsharded)")
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="soft per-epoch budget before the ladder stops escalating")
    ap.add_argument("--backoff-s", type=float, default=0.0,
                    help="base of the exponential retry backoff between ladder rungs")
    ap.add_argument("--compare-cold", action="store_true",
                    help="also run a solve-from-scratch on warm event-epochs and record its rounds "
                    "(the warm-start efficiency baseline)")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--events-out", default=None,
                    help="write the generated fault trace (the replayable event schedule) to this "
                    "JSON path")
    ap.add_argument("--trace-out", default=None, help="host span trace JSONL")
    ap.add_argument("--assert-feasible", action="store_true",
                    help="exit nonzero unless every epoch was feasible with finite J")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rank = init_from_env(dev)

    if args.trace_out and rank == 0:
        obs_trace.configure(enabled=True, jsonl_path=args.trace_out,
                            chrome_path=obs_trace.chrome_path_for(args.trace_out))
    elif rank == 0:
        obs_trace.maybe_configure_from_env()

    with span("launch.control.build", instances=args.instances):
        fleet = sample_fleet(args.instances, families=args.families.split(","), seed=args.seed,
                             device=dev)
        trace = generate_trace(
            fleet, args.epochs, seed=args.seed + 1, node_failures=args.node_failures,
            link_degradations=args.link_degradations, flash_crowds=args.flash_crowds,
        )
    if args.events_out and rank == 0:
        trace.save(args.events_out)

    ctl = run_control(
        fleet, trace=trace, m_max=args.m_max, t_phi=args.t_phi, solver=args.solver,
        round_to=args.round_to, shard=args.shard, devices=args.devices, timeout_s=args.timeout_s,
        backoff_s=args.backoff_s, compare_cold=args.compare_cold,
        verify_hop_bound=args.verify_hop_bound, verify_apsp0=args.verify_apsp0,
        block_apps=args.block_apps, lane_chunk=args.lane_chunk, device=dev,
    )
    s = ctl.summary()
    out = {
        "summary": s,
        "metrics": obs_metrics.registry.snapshot(),
        "epochs": [r.to_dict() for r in ctl.reports],
    }
    if rank == 0:
        print(json.dumps(out, indent=1, default=str), flush=True)
        if args.json_out:
            with open(args.json_out, "w") as fh:
                json.dump(out, fh, indent=1, default=str)
        obs_trace.flush()
    if args.assert_feasible and (s["infeasible_epochs"] or s["nonfinite_epochs"]):
        print(
            f"ASSERTION FAILED: {s['infeasible_epochs']} infeasible / "
            f"{s['nonfinite_epochs']} non-finite epochs",
            flush=True,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
