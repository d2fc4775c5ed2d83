"""The least time a round of the alternating method needs on one NVIDIA
H100, from the real (unpadded) networks' sizes alone, whatever implements
it. Padding is not work, so a program that pads less gains.

Per network of n real nodes, A apps and K = P + 1 stages, and per round:

  forwarding  t_phi sweeps, each reading and writing phi once
              (A K n^2 fp32 values each way), and each running two
              Neumann solves per (app, stage): the traffic and the
              marginal solve, each reading its operator (n^2), right-hand
              side (n) and writing its result (n) once, 2 n^2 operations
  placement   one all-pairs shortest-path closure of the link marginals by
              min-plus squaring: ceil(log2(hop bound)) products, each
              reading two n x n operands and writing one, 2 n^3 operations

The bound is the larger of the bytes over the memory bandwidth and the
operations over the float32 rate outside the tensor cores (NVIDIA's data
sheet, SXM part, at its full 700 W; a card set below that runs slower, so
every share is stated with the card's power limit).
"""
from __future__ import annotations

import math

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP32 = 4


def hop_bound(adj: np.ndarray) -> int:
    """Unweighted diameter + 2 (one host re-injection per stage hand-off),
    by breadth-first search from every node at once."""
    step = torch.as_tensor(np.asarray(adj) > 0, dtype=torch.float32)
    reach = torch.eye(step.shape[0], dtype=torch.bool)
    diam = 0
    while True:
        nxt = reach | ((reach.to(torch.float32) @ step) > 0)
        if torch.equal(nxt, reach):
            return diam + 2
        reach = nxt
        diam += 1


def network_round(net: dict, t_phi: int) -> dict:
    n, A = net["adj"].shape[0], net["src"].shape[0]
    K = int(net["parts"][0]) + 1
    phi = A * K * n * n
    solve_bytes = (n * n + 2 * n) * FP32
    sweep_bytes = 2 * phi * FP32 + 2 * A * K * solve_bytes
    sweep_ops = 2 * A * K * 2 * n * n
    squarings = math.ceil(math.log2(hop_bound(net["adj"])))
    return {"bytes": t_phi * sweep_bytes + squarings * 3 * n * n * FP32,
            "ops": t_phi * sweep_ops + squarings * 2 * n ** 3}


def round_work(nets: list, t_phi: int) -> dict:
    """Bytes, operations and the least seconds of one round over `nets`."""
    parts = [network_round(net, t_phi) for net in nets]
    b = sum(p["bytes"] for p in parts)
    o = sum(p["ops"] for p in parts)
    return {"bytes": b, "ops": o, "seconds": max(b / HBM_BYTES_PER_S, o / FP32_OPS_PER_S)}
