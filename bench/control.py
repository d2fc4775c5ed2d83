"""Readings that set a cell's limits: the program's numbers and the
control's on several seeds, at the cell's own size, in one process.

    python3 bench/control.py --workload fleet64.replan --seeds 11,12,13 --seconds 5

For each seed it sets the cell up as a run does, runs a short window of
the cell's own traffic, and judges every answer the run would judge twice:
as the program returned it, and with the control in the program's place
(the reference one precision below the configuration's float32: J
computed in bfloat16 from the same placement and forwarding, the
forwarding fractions rounded to bfloat16). The control has to fail at
least one number. One JSON line a seed; the benchmark's runs never run
this. `--plant <fault>` reads the program with a fault of `plant.py`
planted instead, for the numbers the control cannot fail.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "bench"))
sys.path.insert(0, str(ROOT / "src"))


def answers(run, state, record):
    """(lane networks under their health, x, phi, J, hosts) of every answer
    the cell's judge reads, on the lanes it judges."""
    import torch

    import harness
    from reference import judge as ref

    if "replans" in record:
        yield from run.cell.driver().answers(run, state, record["kept"])
        return
    lanes = harness.judged_lanes(run, len(state["nets"]))
    idx = torch.as_tensor(lanes)
    for r in record["epochs"]:
        if "answer" in r:
            healths = state["healths"][r["epoch"]]
            nets = [ref.apply_health(state["nets"][i], healths[i]) for i in lanes]
            x, phi = r["answer"]
            yield (nets, x[idx.to(x.device)], phi[idx.to(phi.device)], r["J"][lanes],
                   r["hosts"][lanes])


def readings(name: str, seed: int, seconds: float, device="cuda", root: Path = ROOT,
             fault: str | None = None) -> dict:
    import numpy as np
    import torch

    import harness
    from plant import planted
    from reference import judge as ref

    cell = harness.find_cell(name, root)
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False,
                      device=torch.device(device), t_start=time.perf_counter(),
                      profiler=harness.Profiler(False))
    drv = cell.driver()
    with planted(fault):
        state = drv.setup(run)
        record = drv.window(run, state)
    state["problems"] = None
    program, control = {}, {}
    for nets, x, phi, J, hosts in answers(run, state, record):
        base = [ref.baseline(net, phi.device) for net in nets]
        harness.judge_answer(nets, x, phi, J, hosts, cell.limits, program, base)
        lo = [ref.control_answer(net, x[b], phi[b]) for b, net in enumerate(nets)]
        phi_lo = torch.stack([p for _, p in lo])
        harness.judge_answer(nets, x, phi_lo, np.array([j for j, _ in lo]), hosts, cell.limits,
                             control, base)
    return {"workload": name, "seed": seed, "fault": fault, "program": program, "control": control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--plant", default=None,
                    help="read the program with a fault of bench/plant.py planted instead")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds, fault=args.plant)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
