"""One forwarding sweep's update of phi: CUDA tensors launch the
hand-written kernel (csrc/forwarding.cu), one launch a sweep; CPU tensors
run the plain tail (`ref.update_phi_ref`). There is no fallback between
the two.

The kernel takes the plain tail's inputs and returns a new phi, every entry
off the minimum-marginal column j* bitwise the plain tail's. The launch
shape follows the node count V alone (`_geometry`): whole rows in
registers up to V = 1,024 (on 4 to 32 lanes a row), a streamed walk past it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import update_phi_ref

_WARPS = 4  # warps a CTA at most
_SEGS = (4, 8, 16, 32)  # lanes a row
_NPL = (8, 16, 32)  # values of a row a lane: the register-resident instances
_SMEM_MAX = 227 * 1024


def _geometry(v: int) -> tuple[int, int, int, int]:
    """(npl, vec, seg, warps) for rows of `v` nodes: a row on `seg` lanes,
    the fewest that hold it at 8 values a lane, `npl` values a lane (0: the
    streamed kernel) as vectors of `vec` columns, `warps` a CTA of 32 / seg
    rows each."""
    seg = next(g for g in _SEGS if 8 * g >= v or g == _SEGS[-1])
    need = -(-v // seg)
    npl = next((n for n in _NPL if n >= need), 0)
    if npl == 0:
        if 2 * v * 4 > _SMEM_MAX:
            raise ValueError(f"forwarding_sweep: {v} nodes exceed the streamed kernel's shared memory")
        return 0, 1, _SEGS[-1], _WARPS
    return npl, 4 if v % 4 == 0 else 1, seg, min(_WARPS, -(-v // (32 // seg)))


def _variant(npl: int, seg: int) -> str:
    return f"s{seg}_w{npl}_resident" if npl else "streamed"


def _aligned(t):
    """`t` contiguous from a 16-byte boundary: the kernel reads rows of phi,
    q and dp in 16-byte vectors."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(phi, q, dp, L, adj, mass, alpha):
    tensors = {"phi": phi, "q": q, "dp": dp, "L": L, "adj": adj, "mass": mass}
    bad = {k: t.dtype for k, t in tensors.items() if t.dtype != torch.float32}
    if bad:
        raise TypeError(f"forwarding_sweep: float32 inputs required, got {bad}")
    if phi.ndim != 5 or phi.shape[-1] != phi.shape[-2]:
        raise ValueError(f"forwarding_sweep: phi {tuple(phi.shape)} is not [B, A, K, V, V]")
    b, a, k, v, _ = phi.shape
    want = {"q": (b, a, k, v), "dp": (b, v, v), "L": (b, a, k), "adj": (b, v, v), "mass": (b, a, k, v)}
    wrong = {n: tuple(tensors[n].shape) for n, s in want.items() if tuple(tensors[n].shape) != s}
    if wrong:
        raise ValueError(f"forwarding_sweep: {wrong} for phi {tuple(phi.shape)}")
    npl, vec, seg, warps = _geometry(v)
    fn = _build.load("forwarding").forwarding_sweep
    out = torch.empty(phi.shape, dtype=phi.dtype, device=phi.device)
    if out.numel() == 0:
        return out
    args = [_aligned(t) for t in (phi, q, dp, L, adj, mass)] + [out]
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(phi.device):
        err = fn(*(t.data_ptr() for t in args), b, a * k, v, npl, vec, seg, warps, alpha, _build.stream_of(phi))
        _build.count("forwarding_sweep", _variant(npl, seg))
    _build.check(err, "forwarding_sweep")
    return out


def update_phi(phi, q, dp, L, adj, mass, alpha):
    """The new phi [B, A, K, V, V] of one forwarding sweep (see
    `ref.update_phi_ref`), newly allocated."""
    if phi.device.type == "cpu":
        return update_phi_ref(phi, q, dp, L, adj, mass, alpha)
    return _launch(phi, q, dp, L, adj, mass, alpha)
