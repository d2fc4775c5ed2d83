"""Run one cell of the benchmark and print its result as the last line.

    python3 bench/run.py --workload fleet64.replan --seed 7 --seconds 40 --trace 0

From the root of a checkout, on a machine with an NVIDIA GPU. It sets up
the cell (inputs from `--seed`, the program's kernels built or loaded,
one warm-up pass of the cell's own shapes), measures for `--seconds`, then
judges what the timed path returned with the plain reference in
`bench/reference/`. `--trace 1` reports the cell's per-layer metrics
instead of its end-to-end ones. The compared numbers and their limits are
the last lines on standard error and the last key of the result.

Exit codes: 0 with a result line; 2 for bad arguments or a missing
program; 3 without enough CUDA devices; 4 when a forbidden module (JAX or
the JAX package) was loaded. No result is printed unless the code is 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Build and compile caches live at fixed paths inside the checkout.
_CACHE = ROOT / "build" / "bench_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(_CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(_CACHE / "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", str(_CACHE / "cuda"))
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "4")
sys.path.insert(0, str(ROOT / "bench"))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("bench: the program (src/repro_torch) is not in this checkout", file=sys.stderr)
        return 2
    import harness

    try:
        cell = harness.find_cell(args.workload)
    except (KeyError, FileNotFoundError) as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    torch.zeros(1, device="cuda")
    print(f"bench: set-up: torch imported {t_torch - T_START:.3f} s, CUDA context "
          f"{time.perf_counter() - t_torch:.3f} s", file=sys.stderr)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"bench: forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
