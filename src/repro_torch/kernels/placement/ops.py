"""The sequential placement sweep: CUDA tensors launch the hand-written
kernel (csrc/placement.cu), one launch a sweep; CPU tensors run the plain
scan (`ref.sequential_sweep`). There is no fallback between the two.

The kernel takes the plain path's inputs as `core/placement.py` forms them
and returns its hosts bitwise. What does not depend on the sweep's loads is
computed here, once a call, by the torch operations the plain path runs:
the compute marginal's terms (`costs.mm1_prime_terms`; under the `linear`
cost the marginal itself), the apps' own loads and, under `colocate`, the
summed weights and loads and the final stage's rates. The launch shape
follows the lane's node count alone (`_geometry`).
"""
from __future__ import annotations

import ctypes

import torch

from ...core import costs
from .. import _build
from .ref import sequential_sweep

_WARP = 32
_MAX_THREADS = 1024
_NODES_PER_THREAD = (1, 2, 4, 8)  # the kernel's instances


def _geometry(n: int) -> tuple[int, int]:
    """(threads a CTA, nodes a thread) for lanes of `n` nodes: n rounded up
    to whole warps, at most 1,024 threads, each owning `npt` nodes."""
    threads = min(_MAX_THREADS, max(1, -(-n // _WARP)) * _WARP)
    need = -(-n // threads)
    for npt in _NODES_PER_THREAD:
        if npt >= need:
            return threads, npt
    raise ValueError(f"placement_sweep: {n} nodes exceed the kernel's {_MAX_THREADS * _NODES_PER_THREAD[-1]}")


def _launch(problem, hosts, dist, G, cprime, *, colocate, move_margin):
    apps, cm = problem.apps, problem.cost
    b, n_apps, n_parts = hosts.shape
    n = problem.net.n_nodes
    if dist.dtype != torch.float32 or G.dtype != torch.float32:
        raise TypeError(f"placement_sweep: float32 dist and G required, got {dist.dtype}, {G.dtype}")
    if tuple(dist.shape) != (b, n, n) or tuple(G.shape) != (b, n):
        raise ValueError(f"placement_sweep: dist {tuple(dist.shape)}, G {tuple(G.shape)} for B={b}, V={n}")
    if apps.L.shape[-1] != n_parts + 1:
        raise ValueError(f"placement_sweep: {apps.L.shape[-1]} stage rates for {n_parts} partitions")
    threads, npt = _geometry(n)
    fn = _build.load("placement").placement_sweep
    out = torch.empty_like(hosts)
    if out.numel() == 0:
        return out
    dev = hosts.device

    def flat(t, shape):
        return t.expand(shape).contiguous()

    linear = cm.kind == "linear"
    if linear:
        # cprime does not depend on the load under the linear cost.
        terms = (flat(cprime(G), (b, n)),) * 4
        w_comp = terms[0]
    else:
        terms = tuple(flat(t, (b, n)) for t in costs.mm1_prime_terms(problem.net.nu, cm.rho_max))
        w_comp = flat(torch.as_tensor(cm.w_comp, dtype=torch.float32, device=dev), (b,))
    loads = apps.w * apps.lam[..., None]  # [B, A, P], the plain path's loads_a
    if colocate:
        live = torch.arange(n_parts, device=dev) < apps.parts[..., None]
        sums = (
            torch.where(live, apps.w, 0.0).sum(dim=-1),
            torch.where(live, loads, 0.0).sum(dim=-1),
            torch.gather(apps.L, 2, apps.parts[..., None])[..., 0],
        )
    else:
        sums = (loads,) * 3  # not read
    args = [dist.contiguous(), dist.mT.contiguous(), G.contiguous(), *terms, w_comp, hosts.contiguous(),
            apps.src.contiguous(), apps.dst.contiguous(), apps.parts.contiguous(), apps.L.contiguous(),
            apps.w.contiguous(), loads.contiguous(), *(t.contiguous() for t in sums), out]
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in args), b, n_apps, n_parts, n, threads, npt, int(colocate), int(linear),
                 1.0 - move_margin, _build.stream_of(hosts))
        _build.count("placement_sweep")
    _build.check(err, "placement_sweep")
    return out


def placement_sweep(problem, hosts, dist, G, cprime, *, colocate, move_margin):
    """The sequential sweep's new hosts [B, A, P] (int64) from the old
    `hosts`, the APSP `dist` [B, V, V], the load `G` [B, V] and the compute
    marginal `cprime` (see `ref.sequential_sweep`)."""
    if hosts.device.type == "cpu":
        return sequential_sweep(problem, hosts, dist, G, cprime, colocate=colocate, move_margin=move_margin)
    return _launch(problem, hosts, dist, G, cprime, colocate=colocate, move_margin=move_margin)
