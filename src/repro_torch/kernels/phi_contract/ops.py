"""cost_to_go's two contractions of phi: CUDA tensors launch the
hand-written kernels (csrc/phi_contract.cu), one launch a call covering
every stage; CPU tensors run the plain versions (`ref`). There is no
fallback between the two.

  phi_loads      F [B, V, V] = sum_k sum_a L t_i phi_ij, `core.flow.loads`'
                 link load
  phi_link_term  [B, A, K, V] = L sum_j phi_ij dp_ij, `core.marginals.
                 cost_to_go`'s link term

Each is the other's adjoint, so on the card each is a
`torch.autograd.Function` whose backward launches the other: the gradient
of F in t is the link term with F's gradient in dp's place, the gradient
of the link term in dp is the load with its gradient in t's place. The
gradients in phi are plain outer products, formed only when phi needs one.
The link term's launch shape follows V alone, as the forwarding sweep's
does (`forwarding.ops._geometry`).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..forwarding import ops as fw_ops
from .ref import phi_link_term_ref, phi_loads_ref


def _check(what, phi, **others) -> tuple[int, int, int, int]:
    """(B, A, K, V) of phi after checking the operands the kernels take:
    float32, on phi's device, t [B, A, K, V], dp [B, V, V], L [B, A, K]."""
    tensors = {"phi": phi, **others}
    bad = {n: t.dtype for n, t in tensors.items() if t.dtype != torch.float32}
    if bad:
        raise TypeError(f"{what}: float32 inputs required, got {bad}")
    if phi.ndim != 5 or phi.shape[-1] != phi.shape[-2]:
        raise ValueError(f"{what}: phi {tuple(phi.shape)} is not [B, A, K, V, V]")
    b, a, k, v, _ = phi.shape
    want = {"t": (b, a, k, v), "dp": (b, v, v), "L": (b, a, k)}
    wrong = {n: tuple(t.shape) for n, t in others.items() if tuple(t.shape) != want[n]}
    if wrong:
        raise ValueError(f"{what}: {wrong} for phi {tuple(phi.shape)}")
    away = {n: str(t.device) for n, t in others.items() if t.device != phi.device}
    if away:
        raise ValueError(f"{what}: {away} not on phi's device {phi.device}")
    return b, a, k, v


def _launch_loads(phi, t, L):
    b, a, k, v = _check("phi_loads", phi, t=t, L=L)
    vec = 4 if v % 4 == 0 else 1
    fn = _build.load("phi_contract").phi_loads
    out = torch.empty((b, v, v), dtype=phi.dtype, device=phi.device)
    if out.numel() == 0:
        return out
    args = [fw_ops._aligned(x) for x in (phi, t, L)] + [out]
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    with torch.cuda.device(phi.device):
        err = fn(*(x.data_ptr() for x in args), b, a, k, v, vec, _build.stream_of(phi))
        _build.count("phi_loads", f"vec{vec}")
    _build.check(err, "phi_loads")
    return out


def _launch_link_term(phi, dp, L):
    b, a, k, v = _check("phi_link_term", phi, dp=dp, L=L)
    npl, vec, seg, warps = fw_ops._geometry(v)
    fn = _build.load("phi_contract").phi_link_term
    out = torch.empty((b, a, k, v), dtype=phi.dtype, device=phi.device)
    if out.numel() == 0:
        return out
    args = [fw_ops._aligned(x) for x in (phi, dp, L)] + [out]
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    with torch.cuda.device(phi.device):
        err = fn(*(x.data_ptr() for x in args), b, a * k, v, npl, vec, seg, warps, _build.stream_of(phi))
        _build.count("phi_link_term", fw_ops._variant(npl, seg))
    _build.check(err, "phi_link_term")
    return out


class _PhiLoads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, phi, t, L):
        out = _launch_loads(phi, t, L)
        ctx.save_for_backward(phi, t, L)
        return out

    @staticmethod
    def backward(ctx, g):
        phi, t, L = ctx.saved_tensors
        need_phi, need_t, need_L = ctx.needs_input_grad
        grad_t = phi_link_term(phi, g, L) if need_t else None
        grad_L = (t * phi_link_term(phi, g, torch.ones_like(L))).sum(dim=-1) if need_L else None
        grad_phi = (L[..., None] * t)[..., None] * g[:, None, None] if need_phi else None
        return grad_phi, grad_t, grad_L


class _PhiLinkTerm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, phi, dp, L):
        out = _launch_link_term(phi, dp, L)
        ctx.save_for_backward(phi, dp, L)
        return out

    @staticmethod
    def backward(ctx, g):
        phi, dp, L = ctx.saved_tensors
        need_phi, need_dp, need_L = ctx.needs_input_grad
        grad_dp = phi_loads(phi, g, L) if need_dp else None
        grad_L = (g * phi_link_term(phi, dp, torch.ones_like(L))).sum(dim=-1) if need_L else None
        grad_phi = (L[..., None] * g)[..., None] * dp[:, None, None] if need_phi else None
        return grad_phi, grad_dp, grad_L


def phi_loads(phi, t, L):
    """Link load F [B, V, V] from phi [B, A, K, V, V], the stage traffic t
    [B, A, K, V] and the stage rates L [B, A, K] (see `ref.phi_loads_ref`),
    newly allocated; differentiable in all three."""
    if phi.device.type == "cpu":
        return phi_loads_ref(phi, t, L)
    return _PhiLoads.apply(phi, t, L)


def phi_link_term(phi, dp, L):
    """The cost-to-go's link term [B, A, K, V] of every stage from phi
    [B, A, K, V, V], dp [B, V, V] (0 off the edges) and L [B, A, K] (see
    `ref.phi_link_term_ref`), newly allocated; differentiable in all
    three."""
    if phi.device.type == "cpu":
        return phi_link_term_ref(phi, dp, L)
    return _PhiLinkTerm.apply(phi, dp, L)
