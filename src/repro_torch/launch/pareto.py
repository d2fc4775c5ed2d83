"""Split-point Pareto search CLI (DESIGN.md section 17); the JAX
package's `launch/pareto.py` on PyTorch, with its flags less
`--use-pallas` / `--interpret`, plus `--device` (default cuda: without a
GPU it raises unless `--device cpu` is given).

Enumerates per-architecture candidate split sets (every cut point x P in
{1..4}) for the model zoo, solves ALL candidates over a (topology, load,
eta) grid as ONE batched `solve_fleet` call, and emits the dominated-point-
filtered latency/compute/egress Pareto front per (architecture, topology,
load).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.pareto --archs qwen1.5-0.5b,mamba2-370m \
      --topologies iot --max-per-p 2 --m-max 2 --t-phi 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.pareto --assert-front \
      --json-out fronts.json --plot-out plots/

Observability: `--trace-out spans.jsonl` records the host span trace
(enumerate/build/solve/extract); the JSON carries the obs metrics snapshot
(candidates solved, cut sets dropped, front sizes, pad overhead).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

from ..configs import ZOO
from ..core import SCENARIOS
from ..device import resolve_device
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..partition.pareto import check_fronts, sweep_zoo


def write_front_plots(report: dict, out_dir: str) -> list[str]:
    """Scatter each cell's candidates (latency vs egress, compute as size)
    with the Pareto front highlighted. Gated on matplotlib: environments
    without it get a clean skip, not a crash."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("plot: matplotlib not installed — skipping front plots")
        return []
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for cell in report["cells"]:
        pts = cell["points"]
        lat = [p["latency"] for p in pts]
        egr = [p["egress"] for p in pts]
        on = [p["on_front"] for p in pts]
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.scatter(
            [x for x, f in zip(lat, on) if not f],
            [y for y, f in zip(egr, on) if not f],
            s=12, alpha=0.4, label="dominated",
        )
        fr = sorted(
            ((lat[i], egr[i]) for i in cell["front"]), key=lambda t: t[0]
        )
        ax.plot(
            [x for x, _ in fr], [y for _, y in fr],
            "ro-", ms=5, lw=1, label=f"front ({cell['front_size']})",
        )
        ax.set_xlabel("latency (J_comm + J_comp)")
        ax.set_ylabel("egress (bytes/s on links)")
        ax.set_title(
            f"{cell['arch']} @ {cell['topology']} load={cell['load']}"
        )
        ax.legend(fontsize=8)
        fig.tight_layout()
        path = out / (
            f"front_{cell['arch']}_{cell['topology']}_"
            f"load{cell['load']:g}.png"
        )
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(str(path))
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--archs",
        default=None,
        help=f"comma-separated architectures (default: all {len(ZOO)} zoo "
        "configs)",
    )
    ap.add_argument(
        "--topologies",
        default="iot,mesh",
        help=f"comma-separated scenarios ({','.join(SCENARIOS)})",
    )
    ap.add_argument("--loads", default="1.0", help="comma-separated load scales")
    ap.add_argument(
        "--etas",
        default="0.5",
        help="comma-separated comm/comp weightings (Fig-5 axis); each eta "
        "solves every candidate once and the fronts pool across etas",
    )
    ap.add_argument(
        "--parts", default="1,2,3,4", help="comma-separated split depths"
    )
    ap.add_argument(
        "--max-per-p",
        type=int,
        default=16,
        help="candidate cut sets kept per (arch, P) — deterministic "
        "evenly-spaced subsample of the full enumeration; the dropped "
        "count is reported, never silent",
    )
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--method", default="ALT")
    ap.add_argument("--m-max", type=int, default=8)
    ap.add_argument("--t-phi", type=int, default=5)
    ap.add_argument("--round-to", type=int, default=8)
    ap.add_argument(
        "--shard",
        action="store_true",
        help="lay the candidate axis over a mesh of devices (one device: "
        "unsharded)",
    )
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--chunk-size", type=int, default=None)
    ap.add_argument(
        "--envelope-cap-gb",
        type=float,
        default=2.0,
        help="bound the per-device [B, A, K, V, V] engine footprint "
        "(auto-chunks the candidate batch)",
    )
    ap.add_argument(
        "--solver", choices=("neumann", "lu"), default="neumann"
    )
    ap.add_argument(
        "--assert-front",
        action="store_true",
        help="hard-gate the report (CI): non-empty finite fronts in every "
        "cell, dominated points actually filtered, fronts re-verified",
    )
    ap.add_argument(
        "--json-out",
        default=None,
        help="write the full report JSON here (stdout gets a summary)",
    )
    ap.add_argument(
        "--plot-out",
        default=None,
        help="write per-cell front plots (PNG) into this directory "
        "(requires matplotlib; skipped cleanly without it)",
    )
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.trace_out:
        obs_trace.configure(
            enabled=True,
            jsonl_path=args.trace_out,
            chrome_path=obs_trace.chrome_path_for(args.trace_out),
        )
    else:
        obs_trace.maybe_configure_from_env()

    t0 = time.time()
    with obs_trace.span("launch.pareto"):
        report = sweep_zoo(
            archs=args.archs.split(",") if args.archs else None,
            topologies=tuple(args.topologies.split(",")),
            loads=tuple(float(x) for x in args.loads.split(",")),
            etas=tuple(float(x) for x in args.etas.split(",")),
            parts=tuple(int(x) for x in args.parts.split(",")),
            max_per_p=args.max_per_p,
            seq_len=args.seq_len,
            method=args.method,
            m_max=args.m_max,
            t_phi=args.t_phi,
            round_to=args.round_to,
            shard=args.shard,
            devices=args.devices,
            chunk_size=args.chunk_size,
            envelope_cap_gb=args.envelope_cap_gb,
            solver=args.solver,
            device=dev,
        )
    dt = time.time() - t0
    report["wall_s"] = round(dt, 2)
    report["candidates_per_s"] = round(report["n_instances"] / dt, 3)
    report["metrics"] = obs_metrics.registry.snapshot()

    if args.assert_front:
        check_fronts(report)
    if args.plot_out:
        report["plots"] = write_front_plots(report, args.plot_out)
    if args.json_out:
        pathlib.Path(args.json_out).write_text(
            json.dumps(report, indent=1) + "\n"
        )
        summary = {
            k: v for k, v in report.items() if k != "cells"
        }
        summary["cells"] = [
            {k: v for k, v in c.items() if k != "points"}
            for c in report["cells"]
        ]
        print(json.dumps(summary, indent=1), flush=True)
    else:
        print(json.dumps(report, indent=1), flush=True)
    obs_trace.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
