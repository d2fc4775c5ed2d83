"""Fleet control-plane CLI: batched re-optimization of scenario ensembles
(the JAX package's `launch/fleet.py`, on PyTorch).

    python -m repro_torch.launch.fleet --families erdos_renyi,iot_hierarchy \\
        --instances 4 --m-max 4 --t-phi 4 --device cpu
    python -m repro_torch.launch.fleet --scenario iot --load-grid 0.4,0.8,1.2 --device cpu

Without `--device cpu` it runs on the GPU (and raises without one).
`--shard` lays the instances over the ranks of a launcher, one process a
device (gloo on the CPU, NCCL on GPUs), and only rank 0 prints:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.fleet --instances 8 --m-max 2 --t-phi 2 --shard --device cpu

The flags are the JAX CLI's, less `--use-pallas` / `--interpret`: the port has
one route, the CUDA kernels on the card and their plain versions on the
CPU, and its JSON reports the route that ran under the same two keys. The
JSON also carries a "metrics" snapshot and the round-trace summary under
"trace". `--trace-out spans.jsonl` (or REPRO_TRACE=spans.jsonl) records the
host span trace, with a Chrome trace_event twin next to it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from ..core import SCENARIOS
from ..device import resolve_device
from ..fleet import FAMILIES, METHODS, load_grid, sample_fleet, solve_fleet
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .mesh import init_from_env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", default=None,
                    help=f"comma-separated generator families ({','.join(FAMILIES)})")
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--partitions", default=None,
                    help="comma-separated DNN split depths (e.g. 1,2,3) cycled across instances; "
                    "with --scenario the first value sets the whole grid's depth. Default: P=2")
    ap.add_argument("--scenario", choices=list(SCENARIOS), default=None,
                    help="use one paper scenario instead of sampled families")
    ap.add_argument("--load-grid", default=None, help="comma-separated load scales applied to --scenario")
    ap.add_argument("--method", choices=list(METHODS), default="ALT")
    ap.add_argument("--m-max", type=int, default=30)
    ap.add_argument("--t-phi", type=int, default=10)
    ap.add_argument("--round-to", type=int, default=8)
    ap.add_argument("--shard", action="store_true",
                    help="lay the instance axis over the launcher's ranks (one rank: unsharded)")
    ap.add_argument("--devices", type=int, default=None,
                    help="cap the mesh to the first N ranks (requires --shard)")
    ap.add_argument("--envelope-cap-gb", type=float, default=None,
                    help="bound one device's [B, A, K, V, V] engine buffers by capping the chunk size")
    ap.add_argument("--solver", choices=("neumann", "lu"), default="neumann",
                    help="linear fixed-point path: hop-capped Neumann propagation (default) or dense LU")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="split fleets larger than this into fixed-B chunks sharing one envelope")
    ap.add_argument("--block-apps", type=int, default=1,
                    help="placement sweep schedule: 1 = sequential scan (default), k > 1 = blocks of "
                    "k apps, 0 = one block; bitwise the same result")
    ap.add_argument("--lane-chunk", type=int, default=None,
                    help="engine layout over the instance axis: 0 or unset = the fused batch, "
                    "k >= 1 = k-lane slices; the same result")
    ap.add_argument("--trace-out", default=None,
                    help="write the host span trace to this JSONL path (a Chrome trace_event file "
                    "lands next to it); REPRO_TRACE=path does the same")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rank = init_from_env(dev)

    if args.trace_out and rank == 0:
        obs_trace.configure(enabled=True, jsonl_path=args.trace_out,
                            chrome_path=obs_trace.chrome_path_for(args.trace_out))
    elif rank == 0:
        obs_trace.maybe_configure_from_env()

    partitions = [int(x) for x in args.partitions.split(",")] if args.partitions else None
    with obs_trace.span("launch.fleet.build", instances=args.instances):
        if args.scenario:
            scales = ([float(s) for s in args.load_grid.split(",")] if args.load_grid
                      else [1.0] * args.instances)
            grid_kw = {"n_parts": partitions[0]} if partitions else {}
            fleet = load_grid(SCENARIOS[args.scenario], scales, device=dev, **grid_kw)
        else:
            families = args.families.split(",") if args.families else None
            fleet = sample_fleet(args.instances, families=families, seed=args.seed,
                                 partitions=partitions, device=dev)

    t0 = time.time()
    with obs_trace.span("launch.fleet.solve", method=args.method, instances=len(fleet)):
        res = solve_fleet(
            fleet, method=args.method, m_max=args.m_max, t_phi=args.t_phi, round_to=args.round_to,
            shard=args.shard, devices=args.devices, solver=args.solver, chunk_size=args.chunk_size,
            envelope_cap_gb=args.envelope_cap_gb, block_apps=args.block_apps,
            lane_chunk=args.lane_chunk, device=dev,
        )
    dt = time.time() - t0
    if rank != 0:
        return 0
    print(json.dumps({
        "method": res.method,
        "solver": args.solver,
        # The route that ran: the CUDA kernels on the card, their plain
        # versions on the CPU (no interpreter either way).
        "use_pallas": dev.type == "cuda",
        "interpret": False,
        "block_apps": args.block_apps,
        "lane_chunk": args.lane_chunk,
        "instances": res.n_instances,
        "partition_mix": sorted({int(p) for p in res.parts[res.app_mask > 0]}),
        "wall_s": round(dt, 2),
        "inst_per_s": round(res.n_instances / dt, 3),
        "rounds": res.rounds,
        "m_max": args.m_max,
        "shard": dataclasses.asdict(res.shard),
        "summary": res.summary(),
        "metrics": obs_metrics.registry.snapshot(),
        "trace": None if res.trace is None else res.trace.to_dict(),
        "per_instance": res.per_instance(),
    }, indent=1), flush=True)
    obs_trace.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
