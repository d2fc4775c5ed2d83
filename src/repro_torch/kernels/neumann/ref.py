"""Plain PyTorch versions of the Neumann propagation solve.

`neumann_propagate_ref` is the CUDA kernel's contract (csrc/neumann.cu)
written with torch tensor operations in fp32: the CPU path of the solver,
and what chip_smoke.py holds the kernel against on the card. `lu_solve_ref`
is the dense reference.
"""
from __future__ import annotations

import torch


def neumann_propagate_ref(
    w: torch.Tensor,
    b: torch.Tensor,
    hops: int,
    tol: float = 1e-6,
    transpose: bool = False,
    operand_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Solve (I - M) x = b by at most `hops` propagation hops x <- b + M x.

    w: [..., V, V], b: [..., V]; M = w^T if `transpose` else w. Per batch
    element, the first hop with max|x_new - x| <= tol * (max|x_new| + 1e-30)
    is applied and the iterate is then frozen (the kernel's early exit).
    `operand_dtype` rounds w through that type first (bf16 operands with fp32
    arithmetic, the kernel's reduced-precision mode)."""
    if operand_dtype is not None:
        w = w.to(operand_dtype)
    w = w.to(torch.float32)
    m = w.mT if transpose else w
    x = b
    done = torch.zeros(b.shape[:-1], dtype=torch.bool, device=b.device)
    for _ in range(hops):
        x_new = b + (m @ x[..., None])[..., 0]
        resid = (x_new - x).abs().amax(dim=-1)
        scale = x_new.abs().amax(dim=-1) + 1e-30
        x = torch.where(done[..., None], x, x_new)
        done = done | (resid <= tol * scale)
        if bool(done.all()):  # every element frozen: later hops are no-ops
            break
    return x


def lu_solve_ref(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(I - m)^{-1} b by dense LU."""
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    return torch.linalg.solve(eye - m, b[..., None])[..., 0]
