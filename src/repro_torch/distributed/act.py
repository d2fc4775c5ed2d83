"""Activation sharding constraints (the JAX package's `distributed/act.py`).

Models stay mesh-agnostic: they call `shard(x, kind)` at named activation
points, and a launcher installs the logical-to-physical mapping with
`activation_sharding(mesh, rules)`. Without a context (unit tests,
one-device runs) `shard` returns its input untouched, so no number moves.

Under a context the model runs on `DTensor`s: its parameters, batch and
caches are laid out by `sharding.distribute_params` / `distribute_batch` /
`distribute_caches`, and `shard` redistributes an activation to the
placements `act_spec` names, the counterpart of JAX's
`with_sharding_constraint`. JAX's constraint lets the SPMD partitioner
choose the collectives; here the redistribute is the collective.

The context also turns on DTensor's implicit replication: the plain
tensors a model builds from shapes alone (positions, masks, RoPE angles)
combine with `DTensor`s as replicated ones. The context is thread-local,
as JAX's is; `enter_context()` re-enters the calling thread's context on
another thread (the recompute of a checkpointed layer, `models/model.py`).
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
from torch.distributed.tensor.experimental import implicit_replication, register_sharding

_TLS = threading.local()

KINDS = ("residual", "heads", "heads_t", "ffn", "logits", "expert_buffers", "moe_groups",
         "tokens_flat", "ssm_inner", "kv_cache", "decode_scores")


def _ctx():
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def activation_sharding(mesh, rules):
    """Install (mesh, rules) for `shard` on this thread; `mesh` is a
    `DeviceMesh` whose dim names include the rules' axes."""
    prev = _ctx()
    _TLS.ctx = (mesh, rules)
    try:
        with implicit_replication():
            yield
    finally:
        _TLS.ctx = prev


def active() -> bool:
    """True under `activation_sharding` on this thread."""
    return _ctx() is not None


def context():
    """(mesh, rules) of this thread's `activation_sharding`, or None."""
    return _ctx()


def enter_context():
    """A context manager that installs, wherever it is entered, the context
    active on the calling thread now (a no-op without one)."""
    ctx = _ctx()
    return contextlib.nullcontext() if ctx is None else activation_sharding(*ctx)


def _batch_axes(rules):
    if rules.pod_axis:
        return (rules.pod_axis, rules.data_axis)
    return rules.data_axis


def act_spec(shape, kind: str, mesh_shape: dict, rules) -> tuple:
    """The partition spec JAX's `shard(x, kind)` constrains an activation
    of `shape` to, on a mesh of `mesh_shape` ({axis name: size}), as a
    tuple in the port's spec convention (`sharding.py`): one entry a dim,
    a name, a tuple of names, or None.

    The batch axes ("pod", "data") go on the leading dim only where their
    product divides it; the model axis only where its size divides the dim
    it would split."""
    m = rules.model_axis
    b = _batch_axes(rules)
    msize = mesh_shape[m]
    bsize = mesh_shape[rules.data_axis] * (mesh_shape[rules.pod_axis] if rules.pod_axis else 1)
    if shape[0] % bsize != 0:
        b = None  # batch=1 long-context cells: replicate the batch dim

    def on_m(dim):
        return m if shape[dim] % msize == 0 else None

    if kind == "residual":  # [B, S, d]
        if rules.seq_shard_residual and shape[1] % msize == 0:
            return (b, m, None)
        return (b, None, None)
    if kind == "heads":  # [B, S, H, hd]
        return (b, None, on_m(2), None)
    if kind == "heads_t":  # [B, H, S, hd]
        return (b, on_m(1), None, None)
    if kind in ("ffn", "logits"):  # [B, S, ff] / [B, S, V]
        return (b, None, on_m(2))
    if kind == "expert_buffers":  # [E, C, d] or [E, C, ff]
        return (on_m(0), None, None)
    if kind == "moe_groups":  # [G, Tg, d] grouped token slabs
        return (b, None, None)  # b is None already where bsize does not divide G
    if kind == "tokens_flat":  # [T, d] / [T, E] flat token tables
        return (b, None)
    if kind == "ssm_inner":  # [B, S, K]
        return (b, None, None)
    if kind == "kv_cache":  # [B, Kv, C, hd]: seq-sharded over model
        return (b, None, on_m(2), None)
    if kind == "decode_scores":  # [B, Kv, G, C]
        return (b, None, None, on_m(3))
    raise ValueError(kind)


def shard(x, kind: str):
    """Constrain activation `x` at a named logical point: `x` itself
    without a context; under one, the `DTensor` redistributed to
    `act_spec`'s placements. A plain tensor under a context raises
    TypeError. A spec longer than `x.ndim` (JAX's constraint fails on it
    and JAX leaves `x` unconstrained) leaves `x` as it is."""
    ctx = _ctx()
    if ctx is None:
        return x
    from .sharding import to_placements  # sharding imports the models, which import this module

    mesh, rules = ctx
    if not isinstance(x, DTensor):
        raise TypeError(f"shard({kind!r}): a plain {type(x).__name__} under activation_sharding; "
                        "a model on a mesh runs on DTensors (sharding.distribute_params)")
    mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))
    spec = act_spec(tuple(x.shape), kind, mesh_shape, rules)
    if len(spec) > x.ndim:
        return x
    return x.redistribute(mesh, to_placements(mesh, spec))


def spec_here(shape, kind: str) -> tuple:
    """`act_spec` of `shape` and `kind` on this thread's context's mesh."""
    mesh, rules = _ctx()
    return act_spec(tuple(shape), kind, dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True)), rules)


def on_local_slabs(fn, args, specs, out_specs):
    """`fn(*args)` on each rank's local tensors, under this thread's
    context: every DTensor argument laid out by its spec first (a
    non-tensor argument, or None, passes as it is; its spec is None), the
    outputs taken as DTensors laid out by `out_specs`. For a computation
    independent across the split dims, whose ops DTensor would otherwise
    re-lay one by one. An argument replicated over a mesh dim that splits
    an output is used by ranks that compute different slices, so its
    gradient is their partial sum there (the redistribute back to its own
    layout reduces it)."""
    from .sharding import to_placements  # sharding imports the models, which import this module

    mesh, _ = _ctx()
    splits = {i for spec in out_specs for i, p in enumerate(to_placements(mesh, spec)) if isinstance(p, Shard)}
    local = []
    for a, spec in zip(args, specs, strict=True):
        if isinstance(a, DTensor):
            pl = to_placements(mesh, spec)
            grad = [Partial() if i in splits and not isinstance(p, Shard) else p for i, p in enumerate(pl)]
            a = a.redistribute(mesh, pl).to_local(grad_placements=grad)
        elif isinstance(a, torch.Tensor):
            raise TypeError("on_local_slabs: a plain tensor under activation_sharding")
        local.append(a)
    outs = fn(*local)
    return tuple(DTensor.from_local(o, mesh, to_placements(mesh, spec), run_check=False)
                 for o, spec in zip(outs, out_specs, strict=True))


def unflatten(y, dim: int, sizes):
    """`y.unflatten(dim, sizes)`. DTensor refuses to unflatten a dim split
    over more ranks than divide its leading factor (a [B, S, H * hd]
    product split 16 ways with H = 8); such a DTensor is first gathered on
    that dim, over the mesh dims whose split does not divide it, as the
    SPMD partitioner re-lays JAX's einsum output."""
    if isinstance(y, DTensor):
        dim, n, pl = dim % y.ndim, 1, list(y.placements)
        for i, p in enumerate(pl):
            if p == Shard(dim):
                if sizes[0] % (n * y.device_mesh.size(i)):
                    pl[i] = Replicate()
                else:
                    n *= y.device_mesh.size(i)
        if pl != list(y.placements):
            y = y.redistribute(y.device_mesh, pl)
        y = _locally_contiguous(y)
    return y.unflatten(dim, sizes)


def _locally_contiguous(t):
    """A DTensor whose local tensor is contiguous. DTensor keeps the global
    strides an op's rule gives, and a redistribute makes its chunks
    contiguous, so the two can disagree; a view decided on the global
    strides then fails on the local tensor."""
    if t.to_local().is_contiguous():
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flatten(w, start: int, end: int):
    """`w.flatten(start, end)`. A DTensor split unevenly on a merged dim
    (5 kv heads over 2 ranks), which DTensor cannot merge, is gathered on
    that dim first; its gradient is unflattened by `unflatten` (the
    gradient of a head-merged weight may come back split where the heads
    do not divide)."""
    if not isinstance(w, DTensor):
        return w.flatten(start, end)
    return _Flatten.apply(w, start % w.ndim, end % w.ndim)


class _Flatten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, start, end):
        ctx.dims = (start, tuple(w.shape[start:end + 1]))
        mesh, pl, split = w.device_mesh, list(w.placements), {}
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and start <= p.dim <= end:
                split[p.dim] = split.get(p.dim, 1) * mesh.size(i)
                if w.shape[p.dim] % split[p.dim]:
                    pl[i] = Replicate()
        if pl != list(w.placements):
            w = w.redistribute(mesh, pl)
        return _locally_contiguous(w).flatten(start, end)

    @staticmethod
    def backward(ctx, g):
        start, sizes = ctx.dims
        return unflatten(g, start, sizes), None, None


def match_layout(x, like, dims: int):
    """`x` laid out as the DTensor `like` on their first `dims` dims and
    replicated on the rest (`x` itself when plain): a decode query joins
    its cache's layout, so the score product is local to each rank and
    merges no two split dims (which DTensor re-lays at great cost)."""
    if not isinstance(x, DTensor):
        return x
    pl = [p if isinstance(p, Shard) and p.dim < dims else Replicate() for p in like.placements]
    return x.redistribute(like.device_mesh, pl)


def softmax_last(x):
    """`torch.softmax(x, -1)`. For a DTensor split on its last dim over
    more than one rank (decode scores over a sequence-split cache) the max
    and the sum are reduced across the split, one number a row each, as
    the SPMD partitioner splits JAX's softmax; DTensor's own rule would
    gather the whole row. A split over one rank gathers nothing and keeps
    `torch.softmax`'s arithmetic (a one-rank mesh stays bitwise)."""
    if not (isinstance(x, DTensor) and any(p == Shard(x.ndim - 1) and x.device_mesh.size(i) > 1
                                           for i, p in enumerate(x.placements))):
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def grad_in_layout(w):
    """`w`, whose gradient is re-laid to `w`'s own placements where it
    arises (`w` itself when plain). A tied table used twice (the lookup and
    the logits head) gets two gradients in two layouts; autograd adds them,
    and some torch releases resolve that add by re-laying a split gradient
    as a partial sum, which DTensor cannot do. Laid out alike, the two add
    rank by rank."""
    if not isinstance(w, DTensor):
        return w
    return _GradInLayout.apply(w)


class _GradInLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        ctx.layout = (w.device_mesh, w.placements)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.layout)


@register_sharding(torch.ops.aten.flip.default)
def _flip_sharding(x, dims):
    """`flip` on one mesh dim, output first: replicated, a partial sum (a
    flip is linear), or split on any dim it does not flip. The gradient of
    a `cumsum` (the SSD scan's) is a flip of a cumsum of a flip."""
    flipped = {d % x.ndim for d in dims}
    out = [([Replicate()], [Replicate(), None]), ([Partial()], [Partial(), None])]
    return out + [([Shard(d)], [Shard(d), None]) for d in range(x.ndim) if d not in flipped]


# `register_sharding` keys its cached decisions on no int-list argument:
# key flip's on its dims too.
DTensor._op_dispatcher.sharding_propagator.op_to_schema_info[torch.ops.aten.flip.default] = (
    RuntimeSchemaInfo(1, needs_pytree=True))
