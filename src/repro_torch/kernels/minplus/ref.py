"""Plain PyTorch versions of the tropical (min,+) product.

(A (x) B)[..., i, j] = min_k A[..., i, k] + B[..., k, j]

`minplus_matmul_ref` / `minplus_matmul_argmin_ref` are one-broadcast oracles
(O(M*K*N) memory). `minplus_matmul_blocked` / `minplus_matmul_argmin_blocked`
stream the K reduction in chunks whose broadcast stays near 2^24 elements;
they are the CPU path of the solver and are bitwise equal to the oracles:
min is exact and each candidate is one fp32 add, and the argmin carry keeps
the first minimum (strict `<` across ascending chunks, torch.argmin's
first-minimum within a chunk).
"""
from __future__ import annotations

import torch

# Broadcast-intermediate budget of one chunk: 2^24 fp32 elements (64 MiB).
_BLOCK_ELEMS = 1 << 24


def minplus_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., M, K] (x) [..., K, N] -> [..., M, N]. Memory O(M*K*N)."""
    return (a[..., :, :, None] + b[..., None, :, :]).amin(dim=-2)


def minplus_matmul_argmin_ref(a: torch.Tensor, b: torch.Tensor):
    """(min_k, first argmin_k) of a[..., i, k] + b[..., k, j]."""
    cand = a[..., :, :, None] + b[..., None, :, :]
    return cand.amin(dim=-2), cand.argmin(dim=-2)


def default_block_k(m: int, k: int, n: int) -> int:
    """Largest multiple-of-8 K chunk whose broadcast fits the element budget
    (m, n include any batch extent)."""
    bk = max(1, _BLOCK_ELEMS // max(m * n, 1))
    bk = max(8, (bk // 8) * 8)
    return min(k, bk)


def _blocked(a, b, block_k, argmin):
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = a[..., 0, 0].numel()
    bk = default_block_k(batch * m, k, n) if block_k is None else min(int(block_k), k)
    acc = idx = None
    for k0 in range(0, k, bk):
        cand = a[..., :, k0:k0 + bk, None] + b[..., None, k0:k0 + bk, :]
        cmin = cand.amin(dim=-2)
        if argmin:
            carg = cand.argmin(dim=-2) + k0
        if acc is None:
            acc = cmin
            idx = carg if argmin else None
        elif argmin:
            upd = cmin < acc
            acc = torch.where(upd, cmin, acc)
            idx = torch.where(upd, carg, idx)
        else:
            acc = torch.minimum(acc, cmin)
    return (acc, idx) if argmin else acc


def minplus_matmul_blocked(a, b, *, block_k: int | None = None) -> torch.Tensor:
    """Tropical product with the K reduction streamed in `block_k` chunks."""
    return _blocked(a, b, block_k, argmin=False)


def minplus_matmul_argmin_blocked(a, b, *, block_k: int | None = None):
    """(min, first argmin) over k, streamed in `block_k` chunks."""
    return _blocked(a, b, block_k, argmin=True)
