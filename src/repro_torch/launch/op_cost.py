"""Op-level cost of a step: the port's counterpart of the JAX package's
`launch/hlo_cost.py`.

JAX costs the optimized HLO of a compiled step. The port has no HLO: it
runs the step once under `OpCost`, a `TorchDispatchMode` that sees every
op PyTorch dispatches, on `meta` tensors (shapes only, nothing computed:
the dry run) or on the card. `analyze` returns JAX's keys:

  flops        every op's count by `torch.utils.flop_counter`'s formulas
               (FlopCounterMode's registry, which holds the flash kernel's
               op, `kernels/flash_attention/ops.py`), with FlopCounterMode's
               rule for the rest: an op with no formula that decomposes is
               counted through its decomposition.
  bytes        operand plus result bytes of every op that moves data (view
               ops move none). Nothing is fused, so this reads above JAX's
               bytes at fusion boundaries; it is no parity metric.
  peak_bytes   the peak of live tensor storage over the step: the
               arguments' storages, plus every storage an op creates from
               its allocation until it is released (a weakref finalizer on
               the storage), as a caching allocator sees the step's own
               tensors.
  collectives  {}: the port has no model-parallel mesh yet.
  warnings     what the count cannot see.

The layers are a Python loop, so there is no loop trip count to scale: a
model of L layers dispatches L layers' ops.
"""
from __future__ import annotations

import weakref

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# Ops that query metadata; FlopCounterMode leaves them to the next handler.
_METADATA_OPS = {
    torch.ops.aten.is_contiguous.default, torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default, torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default, torch.ops.aten.sym_size.default, torch.ops.aten.stride.default,
    torch.ops.aten.sym_stride.default, torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default, torch.ops.aten.numel.default,
    torch.ops.aten.sym_numel.default, torch.ops.aten.dim.default, torch.ops.prim.layout.default,
}
if hasattr(torch.ops.aten, "sym_is_contiguous"):
    _METADATA_OPS.add(torch.ops.aten.sym_is_contiguous.default)

COLLECTIVES_WARNING = (
    "collectives: none counted; the port has no model-parallel mesh yet "
    "(ROADMAP.md, Modules to port, item 3b)"
)


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCost(TorchDispatchMode):
    """Counts FLOPs, bytes and live storage over the ops run inside it.
    `track(tree)` adds tensors that exist before the step (its arguments,
    modules' parameters included) to the live storage."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}
        # Ops found to have no decomposition (that depends on the op alone).
        # FlopCounterMode tries `decompose` on every op (it looks ops up by
        # overload, its formulas are keyed by packet), so an op with both a
        # formula and a decomposition is counted through the decomposition
        # there, and here.
        self._no_decomposition: set = set()

    def track(self, tree) -> None:
        for x in tree_flatten(tree)[0]:
            for t in (list(x.parameters()) + list(x.buffers()) if isinstance(x, nn.Module) else _tensors(x)):
                self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA_OPS:
            return NotImplemented
        if func not in self._no_decomposition and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            self._no_decomposition.add(func)
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self._hold(t)
        return out


def analyze(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once under `OpCost` and return JAX's keys
    (module doc) with the call's result under "out"."""
    with OpCost() as cost:
        cost.track((args, kwargs))
        out = fn(*args, **kwargs)
    return {"flops": cost.flops, "bytes": cost.bytes, "peak_bytes": cost.peak, "collectives": {},
            "warnings": [COLLECTIVES_WARNING], "out": out}
