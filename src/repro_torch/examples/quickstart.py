"""Quickstart: the paper in 40 lines (the JAX package's `examples/quickstart.py`).

Solve congestion-aware joint partition placement + routing on the
IoT-edge-cloud scenario and compare all four methods (paper Fig. 2, IoT
column).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Without `--device cpu` it runs on the GPU (and raises without one).
`main(device)` returns the numbers it prints.
"""
from __future__ import annotations

import argparse

from repro_torch.core import compare_all, iot, stage_traffic
from repro_torch.device import resolve_device

NAMES = ["cloud"] + [f"edge{i}" for i in range(1, 5)] + [f"iot{i}" for i in range(5, 17)]


def main(device: str = "cuda") -> dict:
    """Run the quickstart on `device`. Returns {"J": {method: J},
    "normalized": {method: J / worst}, "hosts": ALT's [A, 2] hosts,
    "wire": bytes on the wire of stages 0-2}."""
    dev = resolve_device(device)
    problem = iot(device=dev)  # 17 nodes: 1 cloud, 4 edge servers, 12 IoT devices
    results = compare_all(problem, device=dev)

    print("Normalized objective (lower is better; ALT is the paper's method):")
    worst = max(r.J for r in results.values())
    for name, r in results.items():
        bar = "#" * int(40 * r.J / worst)
        print(f"  {name:12s} J={r.J:12.2f}  ({r.J / worst:6.3f})  {bar}")

    alt = results["ALT"]
    hosts = alt.state.hosts().cpu().numpy()
    src = problem.apps.src.cpu().numpy()
    print("\nALT placement (partition1 -> partition2) per application:")
    for a in range(min(8, hosts.shape[0])):
        print(f"  app{a}: source={NAMES[src[a]]:6s}  p1@{NAMES[hosts[a, 0]]:6s} "
              f"p2@{NAMES[hosts[a, 1]]:6s}")
    print("  ... (first 8 of", hosts.shape[0], "apps)")

    t = stage_traffic(problem, alt.state)
    # Bytes-on-wire per stage: L_k * sum_links f^{a,k}_{ij}.
    f = t[..., :, None] * alt.state.phi  # [A, K, V, V]
    wire = (problem.apps.L[:, :, None, None] * f).sum(dim=(0, 2, 3)).cpu().numpy()
    print(f"\nBytes-on-wire per stage (size x link crossings): raw={wire[0]:.1f} "
          f"features={wire[1]:.1f} outputs={wire[2]:.1f}")
    print("(raw stage stays near the source — the first partition compresses")
    print(" at the edge before the long haul: the paper's intended structure.)")
    return {
        "J": {name: r.J for name, r in results.items()},
        "normalized": {name: r.J / worst for name, r in results.items()},
        "hosts": hosts,
        "wire": wire,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
