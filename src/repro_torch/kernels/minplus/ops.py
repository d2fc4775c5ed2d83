"""Public wrappers around the min-plus kernel, and APSP on top of it.

`minplus_matmul` / `minplus_matmul_argmin` are the kernel wrappers: CUDA
tensors launch the hand-written kernel (csrc/minplus.cu), CPU tensors run
the blocked plain version; there is no fallback between the two. All
functions take leading batch dims (placement runs one APSP per instance).

APSP is the tropical-squaring closure on both devices (the JAX package's
`use_pallas` algorithm): d <- min(d, d (x) d) until the batch stops
changing, one host read of `any(changed)` per sweep. Lanes that closed
early take extra sweeps that are bitwise no-ops, as under a vmapped
while_loop.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import minplus_matmul_argmin_blocked, minplus_matmul_blocked


def _launch(a: torch.Tensor, b: torch.Tensor, argmin: bool):
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"minplus: a on {a.device}, b on {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"minplus: float32 operands required, got {a.dtype}, {b.dtype}")
    if a.dim() < 2 or b.dim() != a.dim() or a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"minplus: shapes {tuple(a.shape)} (x) {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("minplus: operands must be contiguous")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if k == 0:
        raise ValueError("minplus: empty contraction axis")
    fn = _build.load("minplus").minplus_matmul
    batch = math.prod(a.shape[:-2])
    out = torch.empty(a.shape[:-2] + (m, n), dtype=torch.float32, device=a.device)
    idx = torch.empty(out.shape, dtype=torch.int64, device=a.device) if argmin else None
    if out.numel() == 0:
        return (out, idx) if argmin else out
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        err = fn(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            idx.data_ptr() if argmin else None, batch, m, k, n, _build.stream_of(a),
        )
        _build.LAUNCHES["minplus_argmin" if argmin else "minplus"] += 1
    _build.check(err, "minplus_matmul")
    return (out, idx) if argmin else out


def minplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., M, K] (x) [..., K, N] -> [..., M, N] float32."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return minplus_matmul_blocked(a, b)
    return _launch(a, b, argmin=False)


def minplus_matmul_argmin(a: torch.Tensor, b: torch.Tensor):
    """(min_k a+b, first minimising k as int64), [..., M, N] each."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return minplus_matmul_argmin_blocked(a, b)
    return _launch(a, b, argmin=True)


def squaring_bound(n: int) -> int:
    """Sweeps that provably close any [n, n] seed: paths double per sweep."""
    return max(1, math.ceil(math.log2(max(n - 1, 2))))


def minplus_closure(
    d: torch.Tensor, *, n_iter: int | None = None, early_exit: bool = True
) -> torch.Tensor:
    """Close reflexive `d` [..., V, V] to its transitive (min,+) fixpoint by
    repeated squaring. With `early_exit` the loop stops one sweep after the
    whole batch stops changing; `n_iter` overrides the worst-case cap."""
    sweeps = squaring_bound(d.shape[-1]) if n_iter is None else max(1, int(n_iter))
    d = d.contiguous()
    for _ in range(sweeps):
        nxt = torch.minimum(d, minplus_matmul(d, d))
        changed = early_exit and bool((nxt != d).any())
        d = nxt
        if early_exit and not changed:
            break
    return d


def apsp(
    w: torch.Tensor, *, n_iter: int | None = None, early_exit: bool = True
) -> torch.Tensor:
    """All-pairs shortest paths of [..., V, V] nonnegative weights (BIG on
    non-edges); the diagonal is forced to 0."""
    v = w.shape[-1]
    eye = torch.eye(v, dtype=torch.bool, device=w.device)
    d = torch.where(eye, 0.0, w.to(torch.float32))
    return minplus_closure(d, n_iter=n_iter, early_exit=early_exit)


def apsp_with_nexthop(w: torch.Tensor):
    """APSP distances + next-hop table, nexthop[..., i, t] = first
    argmin_j w[i, j] + dist[j, t]. Following next-hops strictly decreases
    dist[., t], so the induced forwarding is loop-free."""
    dist = apsp(w)
    _, nexthop = minplus_matmul_argmin(w.to(torch.float32).contiguous(), dist)
    return dist, nexthop
