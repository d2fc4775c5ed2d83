"""Fault traffic: the control loop `run_control` replays one seeded fault
trace over the configuration's fleet, warm path, with the verification
gates and the cold comparison off. Each replay starts cold at epoch 0;
replays follow one another until the window closes, and the window ends
at the first epoch boundary after its close.

An event epoch's recovery runs on the benchmark's clock from the moment
the controller takes the epoch from the trace to the return of the solve
it accepted (the result's J is on the host by then). The cold first epoch
of a replay has no event and is no recovery.

The seed draws the networks within the configuration's families and
ranges, and the trace over them with the mix's counts of each kind of
event, so runs of different seeds meet the same number of faults.
"""
from __future__ import annotations

import time

import numpy as np
import torch

import harness
import program
from gen import faults, networks
from reference import judge as ref

TRACE_KEYS = ("node_failures", "link_degradations", "flash_crowds", "min_duration", "max_duration",
              "degrade_range", "crowd_range")


def _program_trace(events, n_epochs, n_inst, clock=None):
    """The events as the program's `FaultTrace`. With a `clock`, the trace
    notes when the controller takes each epoch, and stops handing out
    epochs once the clock's deadline has passed."""
    from repro_torch.chaos import FaultEvent, FaultTrace

    evs = tuple(FaultEvent(epoch=e["epoch"], kind=e["kind"], instance=e["instance"],
                           node=e["node"], edge=tuple(e["edge"]), scale=e["scale"]) for e in events)
    if clock is None:
        return FaultTrace(evs, n_epochs, n_inst)

    class ClockedTrace(FaultTrace):
        def timeline(self):
            for item in FaultTrace.timeline(self):
                if not clock.next_epoch(item[0]):
                    return
                yield item

    return ClockedTrace(evs, n_epochs, n_inst)


class Clock:
    """Per-epoch marks of one window: when each epoch was taken from the
    trace and when its last solve returned. It also starts and stops the
    profiler around the traced epochs and keeps the answers of the
    sampled epochs."""

    def __init__(self, run, deadline, sample, profile_epochs):
        self.run = run
        self.deadline = deadline
        self.sample = set(sample)
        self.profile_epochs = profile_epochs
        self.epochs = []
        self.replay = -1
        self.last = None

    def next_epoch(self, epoch: int) -> bool:
        now = time.perf_counter()
        if now >= self.deadline:
            return False
        if epoch == 0:
            self.replay += 1
        first, count = self.profile_epochs
        if self.replay == 0 and epoch == first:
            self.run.profiler.start()
        if self.replay == 0 and epoch == first + count:
            self.run.profiler.stop()
        self.epochs.append({"replay": self.replay, "epoch": epoch, "taken": now, "solved": None})
        return True

    def on_solve(self, res) -> None:
        rec = self.epochs[-1]
        rec["solved"] = time.perf_counter()
        rec["J"], rec["hosts"] = res.J, res.hosts
        self.last = (rec, res)
        if rec["epoch"] in self.sample:
            rec["answer"] = (res.state.x.clone(), res.state.phi.clone())

    def finish_replay(self, ctl) -> None:
        """Attach the controller's reports; keep the last epoch's answer."""
        mine = [r for r in self.epochs if r["replay"] == self.replay]
        for rec, rep in zip(mine, ctl.reports):
            rec["report"] = rep
        if self.last is not None:
            rec, res = self.last
            rec.setdefault("answer", (res.state.x, res.state.phi))
            self.last = None


def setup(run):
    from repro_torch.launch.control import run_control

    tr = run.cell.traffic
    seed = harness.input_seed(run.seed)
    nets = networks.build(run.cell.config, seed)
    problems = [program.to_problem(net, run.device) for net in nets]
    trace_kw = {k: tuple(tr[k]) if isinstance(tr[k], list) else tr[k] for k in TRACE_KEYS}
    events = faults.generate_trace(nets, tr["epochs"], seed=seed, **trace_kw)
    rng = harness.seed_rng(run.seed, 1)
    # Sampled among the epochs every window reaches.
    event_epochs = sorted({e["epoch"] for e in events if e["epoch"] < tr["sample_before"]})
    sample = rng.choice(event_epochs, size=tr["sample_epochs"], replace=False).tolist()
    kw = dict(program.solver_kwargs(run.cell.config), device=run.device)
    w = tr["warmup_epochs"]
    run_control(problems, trace=_program_trace([e for e in events if e["epoch"] < w], w,
                                               len(nets)), **kw)
    program.sync(run.device)
    return {"nets": nets, "problems": problems, "events": events, "kw": kw,
            "sample": sample,
            "healths": faults.healths_by_epoch(events, tr["epochs"], len(nets))}


def window(run, state):
    import repro_torch.launch.control as control

    tr = run.cell.traffic
    clock = Clock(run, time.perf_counter() + run.seconds, state["sample"],
                  (tr["profile_first_epoch"], tr["profile_epochs"]))
    solve = control.solve_fleet

    def observed_solve(*args, **kwargs):
        res = solve(*args, **kwargs)
        clock.on_solve(res)
        return res

    control.solve_fleet = observed_solve
    try:
        while time.perf_counter() < clock.deadline:
            trace = _program_trace(state["events"], tr["epochs"], len(state["nets"]), clock)
            ctl = control.run_control(state["problems"], trace=trace, **state["kw"])
            clock.finish_replay(ctl)
    finally:
        control.solve_fleet = solve
    return {"epochs": clock.epochs}


def _event_epochs(record):
    return [r for r in record["epochs"] if "report" in r and r["report"].events]


def end_to_end(run, state, record):
    rec = [r["solved"] - r["taken"] for r in _event_epochs(record) if r["solved"] is not None]
    return {"recovery_s": float(np.mean(rec)) if rec else None}


def judge(run, state, record):
    """Every epoch must be served by its first rung with a finite, feasible
    placement; the sampled epochs and each replay's last epoch are judged
    network by network under that epoch's health."""
    limits = run.cell.limits
    state["problems"] = None
    b = len(state["nets"])
    numbers = {}
    attempted = len(record["epochs"]) * b
    failed = 0
    lanes = harness.judged_lanes(run, b)
    idx = torch.as_tensor(lanes)
    for r in record["epochs"]:
        rep = r.get("report")
        if rep is None or rep.outcome != "ok" or not (rep.finite and rep.feasible):
            failed += b
        answer = r.pop("answer", None)
        if answer is None:
            continue
        healths = state["healths"][r["epoch"]]
        nets = [ref.apply_health(state["nets"][i], healths[i]) for i in lanes]
        x, phi = answer[0][idx.to(answer[0].device)], answer[1][idx.to(answer[1].device)]
        rows = harness.judge_answer(nets, x, phi, r["J"][lanes], r["hosts"][lanes], limits,
                                    numbers)
        failed += harness.failing(rows, limits)
    return numbers, attempted, failed
