"""Vocab-parallel embedding lookup and cross entropy over DTensors (the
Megatron-LM layouts), where JAX lets the SPMD partitioner split its
`jnp.take` and `logsumexp` over a vocab-split table.

DTensor's own rules serve neither well: a lookup in a vocab-split table
leaves a masked partial sum whose mask no longer fits the rows once the
batch is re-laid, the logsumexp over vocab-split logits gathers the whole
vocab on every rank, and the gradient of a gather over them builds a
global-size zero tensor. Here each rank works on its own vocab slice and
all-reduces [B, S]-sized numbers (or the [B, S, d] rows) over the mesh
dims that split the vocab. Plain tensors never come here: the models call
these only for a DTensor split on the vocab (`split`).
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def split(t, dim: int) -> bool:
    """True for a DTensor split evenly on `dim` over some mesh dims."""
    if not isinstance(t, DTensor):
        return False
    n = math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements) if p == Shard(dim))
    return n > 1 and t.shape[dim] % n == 0


def _slice(mesh, placements, dim: int, size: int):
    """(mesh dims splitting `dim`, this rank's first index on it, its width)."""
    vdims = [i for i, p in enumerate(placements) if p == Shard(dim)]
    lo = 0
    for i in vdims:  # split in mesh order
        size //= mesh.size(i)
        lo += mesh.get_local_rank(i) * size
    return vdims, lo, size


def _all_reduce(v, op: str, mesh, dims):
    for i in dims:
        v = funcol.all_reduce(v, op, (mesh, i))
    return v


def embedding(tokens, table):
    """F.embedding(tokens, table) for a DTensor table [V, d] split on V:
    the table's other splits (FSDP over "data") are gathered, each rank
    looks up the tokens in its vocab slice (zero rows elsewhere) and the
    rows are summed over the vocab split. The rows [B, S, d] take the
    tokens' batch layout."""
    return _Embedding.apply(tokens, table)


class _Embedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, table):
        mesh = table.device_mesh
        tpl = [p if p == Shard(0) else Replicate() for p in table.placements]
        vdims, lo, width = _slice(mesh, tpl, 0, table.shape[0])
        row_pl = [Replicate() if i in vdims or not isinstance(p, Shard) else p
                  for i, p in enumerate(tokens.placements)]
        w = table.redistribute(mesh, tpl).to_local()
        t = tokens.redistribute(mesh, row_pl).to_local().long()
        in_range = (t >= lo) & (t < lo + width)
        idx = torch.clamp(t - lo, 0, width - 1)
        rows = _all_reduce(F.embedding(idx, w) * in_range[..., None].to(w.dtype), "sum", mesh, vdims)
        ctx.save_for_backward(idx, in_range)
        ctx.layout = (mesh, tpl, row_pl, w.shape)
        return DTensor.from_local(rows, mesh, row_pl, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        idx, in_range = ctx.saved_tensors
        mesh, tpl, row_pl, local_shape = ctx.layout
        g = grad.redistribute(mesh, row_pl).to_local()
        dw = torch.zeros(local_shape, dtype=g.dtype, device=g.device)
        dw.index_add_(0, idx.flatten(), (g * in_range[..., None].to(g.dtype)).flatten(0, -2))
        # Rows from another rank's batch add to the same table rows: the
        # gradient is a partial sum over the batch's mesh dims.
        grad_pl = [Partial() if isinstance(r, Shard) else p for p, r in zip(tpl, row_pl)]
        return None, DTensor.from_local(dw, mesh, grad_pl, run_check=False)


def cross_entropy(logits, targets):
    """Per-token lse(logits) - logits[target] of DTensor logits [B, S, V]
    split on V: the row max, the sum of exponentials and the target logit
    are all-reduced over the vocab split. The gradient, softmax minus the
    one-hot target, stays in the logits' layout. Returns [B, S] losses as
    a DTensor."""
    return _CrossEntropy.apply(logits, targets)


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets):
        mesh = logits.device_mesh
        pl = [Replicate() if p.is_partial() else p for p in logits.placements]
        logits = logits.redistribute(mesh, pl)
        vdims, lo, width = _slice(mesh, pl, 2, logits.shape[2])
        row_pl = [Replicate() if p == Shard(2) else p for p in pl]  # [B, S] rows: batch split kept
        x = logits.to_local()
        t = targets.redistribute(mesh, row_pl).to_local().long()
        m = _all_reduce(x.amax(-1), "max", mesh, vdims)
        lse = m + torch.log(_all_reduce(torch.exp(x - m[..., None]).sum(-1), "sum", mesh, vdims))
        in_range = (t >= lo) & (t < lo + width)
        idx = torch.clamp(t - lo, 0, width - 1)[..., None]
        tl = _all_reduce(torch.gather(x, -1, idx)[..., 0] * in_range, "sum", mesh, vdims)
        ctx.save_for_backward(x, lse, idx, in_range)
        ctx.layout = (mesh, pl, row_pl)
        return DTensor.from_local(lse - tl, mesh, row_pl, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        x, lse, idx, in_range = ctx.saved_tensors
        mesh, pl, row_pl = ctx.layout
        g = grad.redistribute(mesh, row_pl).to_local()
        onehot = torch.zeros_like(x).scatter_(-1, idx, in_range[..., None].to(x.dtype))
        dx = (torch.exp(x - lse[..., None]) - onehot) * g[..., None]
        return DTensor.from_local(dx, mesh, pl, run_check=False), None
