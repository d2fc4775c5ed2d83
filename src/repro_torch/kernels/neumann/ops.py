"""Public wrappers around the Neumann propagation solve.

`neumann_propagate` is the kernel wrapper: on a CUDA tensor it launches the
hand-written kernel (csrc/neumann.cu), on a CPU tensor it runs the plain
version; it never falls back from one to the other. Both kernels split each
operator over a thread-block cluster, the rows kernel by rows (its size
from `_rows_cluster`, on V and the operand size alone), the cols kernel by
columns (`_cols_cluster`, on V alone). `neumann_solve` is the
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
from ...obs.trace import span
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

# neumann_rows keeps a CTA's row block of W in shared memory up to this size,
# so that three CTAs (plus their iterates) share one SM's 227 KB.
_ROWS_BUDGET = 64 * 1024
_CLUSTERS = (1, 2, 4, 8)  # 8: the largest portable cluster
_SMEM_MAX = 227 * 1024
_WARPS = 8  # warps of a CTA of either kernel (csrc/neumann.cu kRowWarps, kColWarps)
_COL_THREADS = 32 * _WARPS  # threads of a neumann_cols CTA (kColThreads)
_COL_REG_ROWS = 16  # rows of its column quad a thread keeps in registers (kColRegRows)
_PAIRS = 4 * _CLUSTERS[-1] * _WARPS * 4  # bytes of every warp's residual pairs, both parities


def _rows_cluster(v: int, esize: int) -> tuple[int, bool]:
    """(C, resident) for neumann_rows on V nodes with `esize`-byte operands:
    the smallest cluster C whose ceil(V / C) x V row block fits
    `_ROWS_BUDGET`, held in shared memory for the whole solve; else C = 8,
    resident while a CTA's shared memory holds its block (V <= 664 in fp32),
    and past that streamed from L2 on every hop."""
    for c in _CLUSTERS:
        if -(-v // c) * v * esize <= _ROWS_BUDGET:
            return c, True
    c = _CLUSTERS[-1]
    return c, _rows_smem(v, esize, c, True) <= _SMEM_MAX


def _rows_smem(v: int, esize: int, c: int, resident: bool) -> int:
    """Shared memory of one neumann_rows CTA (csrc/neumann.cu
    `rows_w_offset`): every warp's residual pairs, an mbarrier, two
    iterates and b, then the resident row block."""
    head = -(-(_PAIRS + 16 + 12 * v) // 16) * 16
    return head + (-(-v // c) * v * esize if resident else 0)


def _cols_layout(v: int, c: int) -> tuple[int, int, int, int]:
    """(R, Q, G, P) of neumann_cols on a cluster of C CTAs (csrc/neumann.cu
    `launch_cols`): R columns a CTA (ceil(V / C), whole quads of 4 where
    V % 4 == 0), Q = ceil(R / 4) column quads, G = 256 // min(Q, 256) row
    groups and P = ceil(V / G) rows a group (whole quads where V % 4 == 0).
    Thread (g, q) holds rows [g P, (g + 1) P) of quad q; past 256 quads
    (G = 1) a thread also takes quads q + 256, q + 512, ..."""
    r = -(-v // c)
    if v % 4 == 0:
        r = -(-r // 4) * 4
    q = -(-r // 4)
    g = _COL_THREADS // min(q, _COL_THREADS)
    p = -(-v // g)
    if v % 4 == 0:
        p = -(-p // 4) * 4
    return r, q, g, p


def _cols_cluster(v: int) -> tuple[int, bool]:
    """(C, resident) for neumann_cols on V nodes: the smallest cluster C
    whose column blocks fit the CTAs' registers (each row group's P rows
    within `_COL_REG_ROWS`; C = 4 at V = 256, one CTA up to V = 128); else
    C = 8 with every row read from L2 on every hop. The registers hold the
    same count of operands in fp32 and bf16."""
    for c in _CLUSTERS:
        if _cols_layout(v, c)[3] <= _COL_REG_ROWS:
            return c, True
    return _CLUSTERS[-1], False


def _cols_smem(v: int, c: int) -> int:
    """Shared memory of one neumann_cols CTA (`cols_smem`): the residual
    pairs and two iterates, then the partial sums of row groups 1..G-1."""
    _, q, g, _ = _cols_layout(v, c)
    return -(-(_PAIRS + 8 * v) // 16) * 16 + 16 * (g - 1) * min(q, _COL_THREADS)


def _variant(c: int, resident: bool) -> str:
    """The launch-count name of a cluster variant, e.g. "c4_resident"."""
    return f"c{c}_{'resident' if resident else 'streamed'}"


def _check_launch(n: int, v: int, c: int, smem: int) -> None:
    """What a clustered launch needs: a size in {1, 2, 4, 8} (which divides
    the grid of n * C CTAs), a grid within 2^31 - 1 CTAs and shared memory
    within the 227 KB a CTA can have."""
    if c not in _CLUSTERS:
        raise ValueError(f"neumann_propagate: cluster size {c} not in {_CLUSTERS}")
    if n * c > 2**31 - 1:
        raise ValueError(f"neumann_propagate: {n} operators x cluster {c} exceed the grid")
    if smem > _SMEM_MAX:
        raise ValueError(f"neumann_propagate: V={v} needs more than {_SMEM_MAX} bytes of shared memory")


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


def _launch(w, b, hops, tol, transpose, attrs) -> torch.Tensor:
    """Kernel launch for CUDA tensors; validates everything it passes on and
    names the variant it launches in `attrs` (the span's, None untraced)."""
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
    n = b.numel() // v if v else 0
    out = b.new_empty(b.shape)
    if n == 0:
        return out
    if transpose:
        c, resident = _cols_cluster(v)
        _check_launch(n, v, c, _cols_smem(v, c))
    else:
        c, resident = _rows_cluster(v, w.element_size())
        _check_launch(n, v, c, _rows_smem(v, w.element_size(), c, resident))
    if attrs is not None:
        attrs["variant"] = _variant(c, resident)
    fn = _build.load("neumann").neumann_propagate
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(w.device):
        err = fn(
            w.data_ptr(), bstride, b.data_ptr(), out.data_ptr(), n, v, int(hops),
            float(tol), int(transpose), int(w.dtype == torch.bfloat16), c, int(resident),
            _build.stream_of(w),
        )
        _build.count("neumann_cols" if transpose else "neumann_rows", _variant(c, resident))
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
    (`neumann_cols` for transpose, `neumann_rows` otherwise) or raise.

    While tracing is on each call is one `kernels.neumann` span: `variant`
    (the launch-count name, e.g. "c8_streamed", or "plain" on the CPU path;
    absent when there is nothing to launch), `systems` (N), `v`, `esize`
    and `transpose`, host values alone."""
    with span("kernels.neumann") as attrs:
        if attrs is not None:
            v = w.shape[-1]
            attrs.update(systems=b.numel() // v if v else 0, v=v, esize=w.element_size(),
                         transpose=bool(transpose))
        if w.device.type == "cpu" and b.device.type == "cpu":
            if attrs is not None:
                attrs["variant"] = "plain"
            return neumann_propagate_ref(w, b, hops, tol, transpose)
        return _launch(w, b, hops, tol, transpose, attrs)


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
