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
  collectives  {JAX's kind name: result bytes} of every collective the
               step makes (`_COLLECTIVES`): empty for plain tensors.
  warnings     what the count cannot see.

On `DTensor`s (a step over a `DeviceMesh`, `launch.mesh.fake_mesh`) the
count is one rank's: `OpCost` hands an op on DTensors back to DTensor, as
torch's `CommDebugMode` does, and counts the local ops and collectives
DTensor then dispatches; the ops DTensor runs on fake tensors to
propagate shapes are not counted. Under a `fake` process group rank 0
holds the largest shard of an uneven split.

The layers are a Python loop, so there is no loop trip count to scale: a
model of L layers dispatches L layers' ops.
"""
from __future__ import annotations

import weakref

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
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

# The collectives DTensor dispatches, by the kind name JAX's dry run reads
# out of its HLO (`repro.launch.dryrun.parse_collective_bytes`).
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute",
    "recv": "collective-permute",
    "permute_tensor": "collective-permute",
}
# Functional-collective plumbing that moves no data.
_COLLECTIVE_PLUMBING = {"wait_tensor", "_wrap_tensor_autograd"}
_COLLECTIVE_NAMESPACES = {"_c10d_functional", "c10d_functional", "_dtensor", "c10d"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


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
        self.collectives: dict[str, int] = {}
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
                self._hold(_local(t))

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
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(isinstance(t, FakeTensor) for t in _tensors((args, kwargs))):
            return func(*args, **kwargs)  # DTensor propagating shapes: no work on the device
        if func.namespace in _COLLECTIVE_NAMESPACES:
            return self._collective(func, args, kwargs)
        if func not in self._no_decomposition and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            self._no_decomposition.add(func)
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors(out)):
            return out  # a factory of DTensor's shape propagation
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self._hold(t)
        return out

    def _collective(self, func, args, kwargs):
        """A collective adds its result bytes under its kind; the plumbing
        around one passes. Anything else in those namespaces raises."""
        name = func._overloadpacket.__name__
        out = func(*args, **kwargs)
        if name in _COLLECTIVE_PLUMBING:
            return out
        if name not in _COLLECTIVES:
            raise NotImplementedError(f"op_cost: collective {func} has no kind in _COLLECTIVES")
        kind = _COLLECTIVES[name]
        outs = _tensors(out)
        self.collectives[kind] = self.collectives.get(kind, 0) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self._hold(t)
        return out


def analyze(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once under `OpCost` and return JAX's keys
    (module doc) with the call's result under "out"."""
    with OpCost() as cost:
        cost.track((args, kwargs))
        out = fn(*args, **kwargs)
    return {"flops": cost.flops, "bytes": cost.bytes, "peak_bytes": cost.peak,
            "collectives": dict(cost.collectives), "warnings": [], "out": out}
