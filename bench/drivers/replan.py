"""Re-plan traffic: one operator re-solves the whole fleet cold, again and
again, a closed loop. Each re-plan is one `solve_fleet` call with the
configuration's budget and `keep_state=True`, timed on the host clock from
the call to its result on the host.

The seed draws the networks within the configuration's families and
ranges; the configuration fixes their sizes, so runs of different seeds
solve different networks of the same shapes.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

import harness
import program
from gen import networks
from reference import judge as ref


def setup(run):
    t_import = time.perf_counter()
    from repro_torch.fleet import solve_fleet

    t0 = time.perf_counter()
    nets = networks.build(run.cell.config, harness.input_seed(run.seed))
    t1 = time.perf_counter()
    problems = [program.to_problem(net, run.device) for net in nets]
    program.sync(run.device)
    t2 = time.perf_counter()
    kw = dict(program.solver_kwargs(run.cell.config), keep_state=True, device=run.device)
    for _ in range(run.cell.traffic["warmup_replans"]):
        solve_fleet(problems, **kw)
    program.sync(run.device)
    t3 = time.perf_counter()
    print(f"bench: set-up: process to driver {t_import - run.t_start:.3f} s, program imported "
          f"{t0 - t_import:.3f} s, inputs drawn "
          f"{t1 - t0:.3f} s, handed over {t2 - t1:.3f} s, warm-up re-plans {t3 - t2:.3f} s",
          file=sys.stderr)
    sample = int(harness.seed_rng(run.seed, 1).integers(0, run.cell.traffic["sample_within"]))
    return {"nets": nets, "problems": problems, "kw": kw, "sample": sample}


def window(run, state):
    from repro_torch.fleet import solve_fleet

    problems, kw = state["problems"], state["kw"]
    replans, kept = [], {}
    t_end = time.perf_counter() + run.seconds
    while time.perf_counter() < t_end:
        i = len(replans)
        if i == 0:
            run.profiler.start()
        n0 = program.launches()
        t0 = time.perf_counter()
        res = solve_fleet(problems, **kw)
        wall = time.perf_counter() - t0
        if i == 0:
            run.profiler.stop()
        replans.append({"wall_s": wall, "rounds": int(res.rounds),
                        "launches": program.launches() - n0, "J": res.J, "hosts": res.hosts})
        if i == state["sample"]:
            kept["sample"] = (i, res)
        kept["last"] = (i, res)
    walls = sorted(r["wall_s"] for r in replans)
    print(f"bench: {len(replans)} re-plans, the first {replans[0]['wall_s']:.4f} s, the second "
          f"{replans[1]['wall_s'] if len(replans) > 1 else float('nan'):.4f} s, median "
          f"{walls[len(walls) // 2]:.4f} s", file=sys.stderr)
    return {"replans": replans, "kept": kept}


def end_to_end(run, state, record):
    reps = record["replans"]
    return {"networks_per_s": len(state["nets"]) * len(reps) / sum(r["wall_s"] for r in reps)}


def answers(run, state, kept):
    """(networks, x, phi, J, hosts) of each judged re-plan, on the judged
    lanes alone: the sampled re-plan and the last one."""
    lanes = harness.judged_lanes(run, len(state["nets"]))
    idx = torch.as_tensor(lanes)
    nets = [ref.apply_health(state["nets"][i], None) for i in lanes]
    seen = set()
    for key in ("sample", "last"):
        if key not in kept or kept[key][0] in seen:
            continue
        i, res = kept[key]
        seen.add(i)
        x, phi = res.state.x, res.state.phi
        yield nets, x[idx.to(x.device)], phi[idx.to(phi.device)], res.J[lanes], res.hosts[lanes]


def judge(run, state, record):
    """The judged lanes (all, or the traffic's `judge_lanes` drawn from the
    seed) of the sampled re-plan and of the last one. A network fails when one of
    its numbers passes its limit; a re-plan whose J is not finite fails all
    its networks."""
    limits = run.cell.limits
    kept = record.pop("kept")
    state["problems"] = None  # the program's inputs are not needed any more
    numbers = {}
    failed = 0
    attempted = len(record["replans"]) * len(state["nets"])
    for r in record["replans"]:
        failed += int((~np.isfinite(r["J"])).sum())
    base = None
    for nets, x, phi, J, hosts in answers(run, state, kept):
        if base is None:
            base = [ref.baseline(net, phi.device) for net in nets]
        rows = harness.judge_answer(nets, x, phi, J, hosts, limits, numbers, base)
        failed += harness.failing(rows, limits)
    return numbers, attempted, failed
