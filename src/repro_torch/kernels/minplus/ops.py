"""Public wrappers around the min-plus kernel, and APSP on top of it.

`minplus_matmul` / `minplus_matmul_argmin` are the kernel wrappers: CUDA
tensors launch the hand-written kernels (csrc/minplus.cu), CPU tensors run
the blocked plain version; there is no fallback between the two. All
functions take leading batch dims (placement runs one APSP per instance).
The argmin kernel splits K over several blocks where its tiles alone
cannot fill the card, chosen from the shape by `_argmin_split`.

APSP is the tropical-squaring closure on both devices (the JAX package's
`use_pallas` algorithm): d <- min(d, d (x) d) until the batch stops
changing, one host read of `any(changed)` per sweep (counted by
`obs.sync.read_flag`). Lanes that closed early take extra sweeps that are
bitwise no-ops, as under a vmapped while_loop.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...obs.sync import read_flag
from .. import _build
from .ref import minplus_matmul_argmin_blocked, minplus_matmul_blocked


# minplus_argmin's launch shape (csrc/minplus.cu): 128 x 64 output tiles,
# 16-deep k stages holding 4-deep chunks, two blocks an SM on the H100's
# 132 SMs.
_ARG_TILE = (128, 64)
_KT = 16
_KC = 4
_ARG_SLOTS = 2 * 132
_MAX_SPLITS = 8
_MIN_SPLIT_STAGES = 4  # stages a split reduces, at the least
_BYTE_IDS = 256  # chunks a split can number in one byte an output


def _argmin_split(batch: int, m: int, n: int, k: int) -> tuple[int, int, bool]:
    """(S, ksplit, wide) for minplus_argmin on [batch, m, k] (x) [batch, k, n]:
    K is split into S ranges of `ksplit` (whole stages, every range
    non-empty) only where the tiles cannot fill the card's block slots, up
    to _MAX_SPLITS and down to _MIN_SPLIT_STAGES stages a range; `wide`
    where a range has more chunks than a byte can number."""
    blocks = batch * -(-m // _ARG_TILE[0]) * -(-n // _ARG_TILE[1])
    nk = -(-k // _KT)
    s = max(1, min(_MAX_SPLITS, _ARG_SLOTS // max(blocks, 1), nk // _MIN_SPLIT_STAGES))
    per = -(-nk // s) * _KT
    return -(-k // per), per, per // _KC > _BYTE_IDS


def _argmin_variant(splits: int, wide: bool) -> str:
    """The launch-count name of an argmin variant, e.g. "s2_u8"."""
    return f"s{splits}_{'u32' if wide else 'u8'}"


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"minplus: a on {a.device}, b on {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"minplus: float32 operands required, got {a.dtype}, {b.dtype}")
    if a.dim() < 2 or b.dim() != a.dim() or a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"minplus: shapes {tuple(a.shape)} (x) {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("minplus: operands must be contiguous")
    if a.shape[-1] == 0:
        raise ValueError("minplus: empty contraction axis")


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_operands(a, b)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    fn = _build.load("minplus").minplus_matmul
    out = torch.empty(a.shape[:-2] + (m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), math.prod(a.shape[:-2]), m, k, n, _build.stream_of(a))
        _build.count("minplus")
    _build.check(err, "minplus_matmul")
    return out


def _launch_argmin(a: torch.Tensor, b: torch.Tensor):
    _check_operands(a, b)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = math.prod(a.shape[:-2])
    splits, ksplit, wide = _argmin_split(batch, m, n, k)
    if ksplit % _KT or not (splits - 1) * ksplit < k <= splits * ksplit or (
            not wide and ksplit // _KC > _BYTE_IDS):
        raise ValueError(f"minplus_argmin: no launch of {splits} splits of {ksplit} over K={k}")
    fn = _build.load("minplus").minplus_matmul_argmin
    out = torch.empty(a.shape[:-2] + (m, n), dtype=torch.float32, device=a.device)
    idx = torch.empty(out.shape, dtype=torch.int64, device=a.device)
    if out.numel() == 0:
        return out, idx
    part_c = part_i = None
    if splits > 1:
        part_c = torch.empty((splits, batch, m, n), dtype=torch.float32, device=a.device)
        part_i = torch.empty((splits, batch, m, n), dtype=torch.int32, device=a.device)
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    with torch.cuda.device(a.device):
        err = fn(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), idx.data_ptr(),
            None if part_c is None else part_c.data_ptr(), None if part_i is None else part_i.data_ptr(),
            batch, m, k, n, splits, ksplit, int(wide), _build.stream_of(a),
        )
        _build.count("minplus_argmin", _argmin_variant(splits, wide))
    _build.check(err, "minplus_matmul_argmin")
    return out, idx


def minplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., M, K] (x) [..., K, N] -> [..., M, N] float32."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return minplus_matmul_blocked(a, b)
    return _launch(a, b)


def minplus_matmul_argmin(a: torch.Tensor, b: torch.Tensor):
    """(min_k a+b, first minimising k as int64), [..., M, N] each."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return minplus_matmul_argmin_blocked(a, b)
    return _launch_argmin(a, b)


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
        changed = early_exit and read_flag((nxt != d).any(), "minplus.closure")
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
