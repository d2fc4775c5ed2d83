"""Public wrappers around the Neumann propagation solve.

`neumann_propagate` is the kernel wrapper: on a CUDA tensor it launches the
hand-written kernel (csrc/neumann.cu), on a CPU tensor it runs the plain
version; it never falls back from one to the other. `neumann_solve` is the
differentiable solve of (I - m) x = b on top of it, a
`torch.autograd.Function` whose backward is the transpose solve through the
same kernel (this replaces `jax.lax.custom_linear_solve`).

The port has one algorithm on both devices, the kernel's contract: a hop
cap of `effective_hops(hop_bound, V, fixed_loop=True)` = hop_bound + 32
with a per-element freeze (the JAX package's `use_pallas` path).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import neumann_propagate_ref

# Extra hops past the nilpotent bound, absorbing the geometric tail of
# blocking-rule transient cycles (gain <= 1 - alpha per sweep). The early
# exit makes the slack cost nothing once phi is loop-free.
NEUMANN_SLACK = 32

# Early-exit threshold: consecutive iterates agreeing to this relative
# tolerance terminate the hop loop (fp32 headroom below the 1e-5 parity
# contract with the LU path).
DEFAULT_TOL = 1e-6

# The TPU's tiled kernel streamed W in [block_k, Vp] row tiles; the CUDA
# kernel has no use for the value but keeps its contract.
LANE = 128


def effective_hops(
    hop_bound: int | None, n_nodes: int, fixed_loop: bool = False
) -> int:
    """Hop cap for one solve.

    With `fixed_loop=False` the floor is the nilpotency-index bound V + 1,
    exact for every truly nilpotent phi. With `fixed_loop=True` (the
    kernel's contract, the one the port runs) the cap is hop_bound + slack:
    the early exit fires at the typical path length, and exactness on
    longer-than-diameter multipath chains is traded for O(V/H) work."""
    base = int(hop_bound) if hop_bound is not None else n_nodes + 1
    if not fixed_loop:
        base = max(base, n_nodes + 1)
    return base + NEUMANN_SLACK


def _batch_stride(t: torch.Tensor, n_tail: int) -> int | None:
    """Element stride between consecutive flattened batch entries of `t`
    (all dims but the last `n_tail`), or None if they do not flatten to one
    stride."""
    dims = [(s, st) for s, st in zip(t.shape[:-n_tail], t.stride()[:-n_tail]) if s != 1]
    if not dims:
        return 0
    stride = expect = dims[-1][1]
    for size, st in reversed(dims):
        if st != expect:
            return None
        expect = st * size
    return stride


def _launch(w, b, hops, tol, transpose) -> torch.Tensor:
    """Kernel launch for CUDA tensors; validates everything it passes on."""
    if w.device.type != "cuda" or b.device.type != "cuda" or w.device != b.device:
        raise ValueError(f"neumann_propagate: w on {w.device}, b on {b.device}")
    if w.dtype not in (torch.float32, torch.bfloat16) or b.dtype != torch.float32:
        raise TypeError(f"neumann_propagate: w {w.dtype} (float32|bfloat16), b {b.dtype} (float32)")
    v = w.shape[-1]
    if w.dim() < 2 or w.shape[-2] != v or b.shape != w.shape[:-1]:
        raise ValueError(f"neumann_propagate: shapes w {tuple(w.shape)}, b {tuple(b.shape)}")
    if w.stride(-1) != 1 or (v > 1 and w.stride(-2) != v):
        raise ValueError("neumann_propagate: w's last two dims must be row-major")
    bstride = _batch_stride(w, 2)
    if bstride is None or not b.is_contiguous():
        raise ValueError("neumann_propagate: w's batch dims must share one stride, b contiguous")
    fn = _build.load("neumann").neumann_propagate
    n = b.numel() // v if v else 0
    out = torch.empty_like(b)
    if n == 0:
        return out
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(w.device):
        err = fn(
            w.data_ptr(), bstride, b.data_ptr(), out.data_ptr(), n, v, int(hops),
            float(tol), int(transpose), int(w.dtype == torch.bfloat16),
            _build.stream_of(w),
        )
        _build.LAUNCHES["neumann_cols" if transpose else "neumann_rows"] += 1
    _build.check(err, "neumann_propagate")
    return out


def neumann_propagate(
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    hops: int,
    tol: float = DEFAULT_TOL,
    transpose: bool = False,
) -> torch.Tensor:
    """x = (I - M)^{-1} b by truncated Neumann propagation, M = w^T if
    `transpose` else w. w: [..., V, V] float32 or bfloat16 (operands read in
    that type, arithmetic in fp32), row-major in its last two dims with one
    batch stride; b: [..., V] float32, contiguous.

    CPU tensors run `neumann_propagate_ref`; CUDA tensors launch the kernel
    (`neumann_cols` for transpose, `neumann_rows` otherwise) or raise."""
    if w.device.type == "cpu" and b.device.type == "cpu":
        return neumann_propagate_ref(w, b, hops, tol, transpose)
    return _launch(w, b, hops, tol, transpose)


def _propagate(m, b, hops, tol, operand_dtype):
    """Solve with operator m (any view): hand the kernel m's storage layout."""
    if operand_dtype is not None:
        m = m.to(operand_dtype)
    v = m.shape[-1]
    if m.stride(-1) == 1 and (v == 1 or m.stride(-2) == v):
        w, transpose = m, False
    elif m.stride(-2) == 1 and m.stride(-1) == v:
        w, transpose = m.mT, True  # phi^T as a view: no copy
    else:
        w, transpose = m.contiguous(), False
    if _batch_stride(w, 2) is None:
        w = w.contiguous()
    return neumann_propagate(w, b.contiguous(), hops=hops, tol=tol, transpose=transpose)


class _NeumannSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, b, hops, tol, operand_dtype):
        x = _propagate(m, b, hops, tol, operand_dtype)
        ctx.save_for_backward(m, x)
        ctx.cfg = (hops, tol, operand_dtype)
        return x

    @staticmethod
    def backward(ctx, g):
        m, x = ctx.saved_tensors
        hops, tol, operand_dtype = ctx.cfg
        # (I - m) x = b  =>  grad_b = (I - m^T)^{-1} g,  grad_m = grad_b x^T.
        grad_b = _propagate(m.mT, g, hops, tol, operand_dtype)
        grad_m = grad_b[..., :, None] * x[..., None, :] if ctx.needs_input_grad[0] else None
        return grad_m, grad_b, None, None, None


def neumann_solve(
    m: torch.Tensor,
    b: torch.Tensor,
    *,
    hops: int,
    tol: float = DEFAULT_TOL,
    block_k: int | None = None,
    operand_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Solve (I - m) x = b by truncated Neumann propagation, differentiable
    in m and b.

    m: [..., V, V] (pass phi^T as a view for the traffic fixed point, phi
    for the cost-to-go), b: [..., V] with matching batch dims.
    `operand_dtype=torch.bfloat16` reads the operator in bf16 with fp32
    arithmetic. `block_k` is the TPU tiled kernel's tile and must be a
    multiple of 128; the CUDA kernel ignores it."""
    if block_k is not None and int(block_k) % LANE:
        raise ValueError(f"block_k must be a multiple of {LANE}, got {block_k}")
    return _NeumannSolve.apply(m, b, hops, tol, operand_dtype)
