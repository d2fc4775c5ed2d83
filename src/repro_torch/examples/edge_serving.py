"""End-to-end partitioned DNN serving over a multi-hop edge network (the JAX
package's `examples/edge_serving.py`).

The full stack in one script, both planes:

  control plane: `repro_torch.core` decides where the two partitions of each
                 model run and how stage 0/1/2 traffic is routed
                 (congestion-aware ALT), fed by architecture profiles from
                 `repro_torch.partition`;
  data plane:    the chosen placement is executed: partition 1 of a real
                 (reduced) model runs at its host, the stage-1 activation is
                 "shipped" along the computed route, partition 2 produces
                 logits at its host; outputs are checked against the
                 monolithic model.

Also shows the paper-native straggler mitigation: degrade a node's compute
rate and watch ALT move partitions off it and re-route.

    PYTHONPATH=src python -m repro_torch.examples.edge_serving [--device cpu]

Without `--device cpu` it runs on the GPU (and raises without one). The
model's weights are random, from a seeded `torch.Generator`; `data_plane`
takes any weights, so the same split can be run on weights from elsewhere.
`main(device)` returns the numbers it prints.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import CostModel, Network, Problem, State, solve_alt, stack_single
from repro_torch.core.flow import objective
from repro_torch.core.structs import BIG
from repro_torch.device import resolve_device
from repro_torch.models import init_params, logits_fn
from repro_torch.partition import apps_from_profiles, profile_arch, run_partition, split_params
from repro_torch.partition.profile import ArchProfile

# An 8-node edge network: 4 devices, 3 edge servers, 1 regional cloud.
N = 8
NAMES = ["dev0", "dev1", "dev2", "dev3", "edge0", "edge1", "edge2", "cloud"]
LINKS = [
    (0, 4), (1, 4), (2, 5), (3, 5),          # device uplinks (weak)
    (4, 5), (5, 6), (4, 6),                  # edge ring
    (6, 7),                                  # edge -> cloud
]
NU = np.array([30e9, 30e9, 30e9, 30e9, 300e9, 300e9, 300e9, 2000e9], np.float32)
ARCHS = ["qwen1.5-0.5b", "gemma-2b", "mamba2-370m", "hymba-1.5b"]
SRC = np.array([0, 1, 2, 3, 0])  # one service per device + video on dev0
LAM = np.array([0.6, 0.4, 0.5, 0.4, 8.0])
SEQ = 64  # data-plane request length


def network(nu: np.ndarray, device) -> Network:
    adj = np.zeros((N, N), np.float32)
    mu = np.full((N, N), BIG, np.float32)
    for u, v in LINKS:
        for i, j in ((u, v), (v, u)):
            adj[i, j] = 1.0
            # devices: 40 MB/s uplinks; backbone: 400 MB/s
            mu[i, j] = 40e6 if u < 4 else 400e6
    return Network(adj=torch.from_numpy(adj).to(device), mu=torch.from_numpy(mu).to(device),
                   nu=torch.from_numpy(np.asarray(nu, np.float32)).to(device))


def profiles() -> list:
    """The four archs' profiles (seq 128 requests), then a perception
    pipeline in the paper's regime."""
    out = [profile_arch(get_config(a), seq_len=128) for a in ARCHS]
    # Token-LM profiles have L1 >> L0 (activations dwarf token ids): ALT will
    # follow COMPUTE for those. The perception pipeline is in the paper's
    # regime (raw video in, small features out: L0 >> L1): ALT should SPLIT
    # it, partition 1 compressing at the edge, partition 2 classifying upstream.
    out.append(ArchProfile(
        arch="perception-cnn", splits=(8,), n_layers_total=32, seq_len=1,
        L_bytes=(2e6, 1.5e5, 1e4),
        w_flops=(3e9, 60e9),
    ))
    return out


def data_plane(cfg, params, tokens: torch.Tensor, *, device) -> dict:
    """Execute app 0's split as placed: partition 1 up to the profiled split
    layer, its activation into partition 2, against the monolithic logits.
    Returns {"k", "act", "logits", "want", "err"}."""
    k = profile_arch(cfg, seq_len=tokens.shape[1]).split_layer
    p1, p2 = split_params(cfg, params, k)
    batch = {"tokens": tokens}
    act = run_partition(cfg, p1, batch, part=1, device=device)        # runs at hosts[0, 0]
    logits = run_partition(cfg, p2, act, part=2, device=device)       # runs at hosts[0, 1]
    want = logits_fn(cfg, params, batch)
    err = float((logits.float() - want.float()).abs().max())
    return {"k": k, "act": act, "logits": logits, "want": want, "err": err}


@torch.no_grad()
def main(device: str = "cuda") -> dict:
    """Run both planes and the straggler re-solve on `device`. Returns
    {"J", "hosts", "data_plane", "params", "tokens", "hot", "J2", "hosts2",
    "stale_J"}: "params" and "tokens" are the data plane's inputs, so a
    caller can run `data_plane` on them elsewhere."""
    dev = resolve_device(device)
    net = network(NU, dev)
    profs = profiles()
    archs = ARCHS + ["perception-cnn"]
    apps = apps_from_profiles(profs, SRC, SRC, LAM, device=dev)
    problem = Problem(net=net, apps=apps, cost=CostModel())

    res = solve_alt(problem, device=dev)
    hosts = res.state.hosts().cpu().numpy()
    print("=== control plane: congestion-aware placement (ALT) ===")
    for a, arch in enumerate(archs):
        ratio = profs[a].compression_ratio()
        regime = "compresses (paper regime)" if ratio < 1 else "activation>input (LM)"
        print(f"  {arch:14s} from {NAMES[SRC[a]]}: partition1 @ {NAMES[hosts[a, 0]]:5s} "
              f"partition2 @ {NAMES[hosts[a, 1]]:5s}  (L1/L0 {ratio:8.2f}: {regime})")
    print(f"  total expected cost J = {res.J:.3f}")

    # Data plane: app 0's model, reduced (same partition structure).
    cfg = reduced_config(archs[0])
    params = init_params(cfg, 0, device=dev)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (1, SEQ), generator=gen).to(dev)
    dp = data_plane(cfg, params, tokens, device=dev)
    act = dp["act"]
    print(f"\n=== data plane ({archs[0]}, split at layer {dp['k']}) ===\n"
          f"  stage-1 activation shipped {NAMES[hosts[0, 0]]} -> {NAMES[hosts[0, 1]]}: "
          f"{act.numel() * act.element_size() / 1e3:.1f} kB")
    print(f"  partitioned output == monolithic output: max err {dp['err']:.2e}")
    assert dp["err"] < 1e-2

    # Straggler mitigation: degrade the busiest host 20x, re-optimize.
    counts = np.bincount(hosts.flatten(), minlength=N)
    hot = int(np.argmax(counts))
    nu2 = NU.copy()
    nu2[hot] /= 20.0  # the node slows down 20x (straggler / contention)
    problem2 = Problem(net=Network(adj=net.adj, mu=net.mu, nu=network(nu2, dev).nu), apps=apps,
                       cost=CostModel())
    res2 = solve_alt(problem2, device=dev)
    hosts2 = res2.state.hosts().cpu().numpy()
    moved = int((hosts2 != hosts).sum())
    print("\n=== straggler mitigation ===")
    print(f"  degraded {NAMES[hot]} 20x -> ALT moved {moved} partition placements")
    for a, arch_name in enumerate(archs):
        if (hosts2[a] != hosts[a]).any():
            print(f"    {arch_name:14s} p1 {NAMES[hosts[a, 0]]}->{NAMES[hosts2[a, 0]]}  "
                  f"p2 {NAMES[hosts[a, 1]]}->{NAMES[hosts2[a, 1]]}")
    stale = State(x=res.state.x[None], phi=res.state.phi[None])
    stale_J = float(objective(stack_single(problem2), stale)[0][0])
    print(f"  cost if routing had stayed stale: {stale_J:.3f}  "
          f"vs re-optimized: {res2.J:.3f}  ({stale_J / res2.J:.1f}x better)")
    assert res2.J < stale_J
    print("\nOK")
    return {"J": res.J, "hosts": hosts, "data_plane": dp, "params": params, "tokens": tokens, "hot": hot,
            "J2": res2.J, "hosts2": hosts2, "stale_J": stale_J}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
