#!/usr/bin/env python3
"""The dot products of the JAX package's partitioned HLO for one dry-run
cell, per device: each dot's output and left-operand shapes, the trip
count of the loops around it, its FLOPs (2 x output x contraction x
trips), largest first, and their sum, which is the record's `hlo_flops`.
It shows which layouts the SPMD partitioner chose (a batch dim left whole,
a contraction split over "data"), to set beside the port's DTensor
records (`tests/test_torch_dryrun.py::test_mesh_record_beside_jax`).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/jax_dryrun_dots.py \\
        --arch qwen1.5-0.5b --shape train_4k [--multi-pod] [--top 25]

Runs on the CPU (`repro.launch.dryrun` sets XLA_FLAGS for its fake
devices when imported); about a minute for qwen1.5-0.5b's train_4k.
"""
from __future__ import annotations

import argparse
import math
import re

_INSTR = re.compile(r"(?:ROOT )?%(\S+) = (.+?) ([a-z][\w\-]*)\((.*)")


def _dims(ty: str):
    m = re.match(r"\w+\[([\d,]*)\]", ty)
    return [int(x) for x in m.group(1).split(",") if x] if m else None


def dots(hlo: str) -> list[tuple]:
    """[(flops, trips, output dims, lhs dims, contraction, op name)] over
    the computations reachable from ENTRY, while bodies times their known
    trip counts."""
    comps, cur = {}, None
    for line in hlo.splitlines():
        m = re.match(r"^(?:ENTRY )?%(\S+) .*\{$", line)
        if m:
            cur = comps.setdefault(m.group(1), [])
        elif line.startswith("}"):
            cur = None
        elif cur is not None and line.strip():
            cur.append(line.strip())
    rows = []

    def visit(name, trips):
        shapes = {}
        for ins in comps[name]:
            m = _INSTR.match(ins)
            if not m:
                continue
            iname, ty, op, rest = m.groups()
            shapes[iname] = _dims(ty)
            if op == "dot":
                lhs = shapes[re.match(r"%([\w.\-]+)", rest).group(1)]
                lc = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", rest).group(1)
                k = math.prod(lhs[int(d)] for d in lc.split(",") if d)
                opname = re.search(r'op_name="([^"]*)"', rest)
                rows.append((2 * math.prod(shapes[iname]) * k * trips, trips, shapes[iname], lhs, k,
                             opname.group(1).rsplit("/", 2)[-2] if opname else ""))
            for key in ("body", "calls", "to_apply"):
                for callee in re.findall(key + r"=%([\w.\-]+)", rest):
                    n = 1
                    if op == "while":
                        tc = re.search(r'known_trip_count":\{"n":"(\d+)"', rest)
                        n = int(tc.group(1)) if tc else 1
                    visit(callee, trips * n)

    visit(re.search(r"^ENTRY %(\S+)", hlo, re.M).group(1), 1)
    return sorted(rows, key=lambda r: -r[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    from repro.launch import dryrun  # sets XLA_FLAGS before jax starts

    import jax
    from repro.distributed.sharding import ShardingRules
    from repro.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    rules = ShardingRules(pod_axis="pod" if args.multi_pod else None)
    step, specs, in_sh, donate = dryrun.build_cell(args.arch, args.shape, mesh, rules)
    with mesh:
        hlo = jax.jit(step, in_shardings=in_sh, donate_argnums=donate).lower(*specs).compile().as_text()
    rows = dots(hlo)
    print(f"{args.arch} {args.shape} {'2x16x16' if args.multi_pod else '16x16'}: per-device dot FLOPs "
          f"{sum(r[0] for r in rows):.6e} over {len(rows)} dots")
    print("flops | trips | output | lhs | contraction | op")
    for flops, trips, out, lhs, k, name in rows[:args.top]:
        print(f"{flops:.4e} | {trips} | {out} | {lhs} | {k} | {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
