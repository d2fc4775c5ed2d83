"""Public attention op: the flash-attention kernel wrapper.

`flash_attention` launches one of the two hand-written CUDA kernels
(csrc/flash_attention.cu) for CUDA tensors and raises if it cannot: the
tensor-core kernel for bf16 with a head dim that is a multiple of 16, the
CUDA-core kernel otherwise (`_variant`, by dtype and head dim alone). CPU
tensors take the plain route the JAX package takes without Pallas:
`attention_ref`, or the streaming `attention_chunked` above
`_CHUNKED_THRESHOLD`. There is no switch and no fallback between them.

The kernel is a dispatcher op, `torch.ops.repro_torch.flash_attention(q, k,
v, causal, window, q_offset)` (`torch.library.custom_op`), so PyTorch's
dispatch modes see it as one op:
- its implementation is the kernel launch (`_launch`), which raises for a
  tensor that is not on a CUDA device; on CPU tensors it is the plain
  route (`_plain`), which the op reaches only from a CPU `DTensor` (a
  mesh of gloo ranks): plain CPU tensors take the plain route directly;
- its fake implementation returns a tensor of q's shape, dtype and layout
  and runs nothing, so a step traces on `meta` tensors (the dry run,
  `launch/dryrun.py`);
- its FLOP formula, 4 * B * H * Sq * Sk * D, is registered with
  `torch.utils.flop_counter`: the two products of every (query, key) pair,
  which is what both plain routes dispatch (`attention_chunked` visits
  every chunk and skips none);
- its autograd is registered with it (below);
- its sharding rule is registered with DTensor (`_flash_sharding`): on
  every mesh dim q, k, v and the output are all split on the batch, all
  split on the heads (only where the split keeps each rank's q heads
  over its own kv heads), or all replicated, so the kernel runs on each
  rank's local tensors and DTensor redistributes any other layout first.
The wrapper sends CUDA and `meta` tensors and every `DTensor` to the op. A plain CUDA call is validated and its library loaded before the
dispatcher sees it (and validated again in the launch); a DTensor call
is validated once, on each rank's local tensors, in the launch: a
DTensor's own strides are global and it has no data pointer.

Gradients. The JAX package has no backward kernel: it trains on its jnp
path, which XLA differentiates. The op's backward is
`flash_attention_backward`, the plain backward: it recomputes the
attention in plain PyTorch on the same device, in fp32, under autograd,
one query chunk at a time, and returns dq, dk, dv. It differentiates the
function the kernel computes, so a query row that sees no key has output
0 and gradient 0. The recompute adds one forward's FLOPs to every
backward (4 * B * H * Sq * Sk * D a call) over what autograd through the
plain route counts. It is the backward's only route; a hand-written
backward kernel is queued (ROADMAP.md, "Modules to port", item 7). The CPU
route is plain PyTorch, which autograd differentiates directly.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from .. import _build
from ...obs.trace import span
from .ref import _mask, attention_chunked, attention_ref

# Above this q*kv sequence product the CPU path streams over chunks (the
# [B, H, Sq, Sk] score tensor would not fit in memory).
_CHUNKED_THRESHOLD = 2048 * 2048

_INT32_MAX = 2**31 - 1
_MAX_Q_BLOCKS = 65535  # gridDim.y limit; the CUDA-core kernel takes 32 query rows a block


def _variant(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call takes: "wgmma" (tensor cores, bf16 operands
    in 16-column steps, fp32 softmax state) for bf16 with d % 16 == 0, else
    "cuda_core" (fp32 arithmetic throughout: tensor cores would mean TF32
    for fp32 inputs)."""
    return "wgmma" if dtype == torch.bfloat16 and d % 16 == 0 and d <= 256 else "cuda_core"


def _check_tma(*ts: torch.Tensor, check_base: bool = True) -> None:
    """The tensor-core kernel loads q, k and v by TMA: 16-byte aligned base
    addresses (not checked on a tensor without data) and strides of whole
    16-byte units in every dim of extent > 1."""
    for t in ts:
        strides = [st for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1]
        if (check_base and t.data_ptr() % 16) or any(st % 8 for st in strides):
            raise ValueError(
                "flash_attention: the bf16 tensor-core kernel needs 16-byte aligned q/k/v "
                f"and strides that are multiples of 8 elements; got strides {tuple(t.stride())}"
            )


def _check(q, k, v, window: int | None, q_offset: int, *, on_device: bool = True) -> str:
    """Every launch rule of the kernel; returns the variant the call takes.
    `on_device=False` (the fake implementation) leaves out the device and
    the base-address checks, which need data."""
    if on_device and (q.device.type != "cuda" or k.device != q.device or v.device != q.device):
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v {q.dtype}/{k.dtype}/{v.dtype}; one of float32, bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, sq, d = q.shape
    kb, kv, sk, kd = k.shape
    if kb != b or kd != d or kv == 0 or h % kv != 0:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not 1 <= d <= 256:
        raise ValueError(f"flash_attention: head dim {d} outside 1..256")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim of q, k and v must be contiguous")
    if b * h > _INT32_MAX or sq > 32 * _MAX_Q_BLOCKS or sk > _INT32_MAX:
        raise ValueError(f"flash_attention: grid too large for shapes {tuple(q.shape)}, {tuple(k.shape)}")
    if window is not None and not 0 <= window <= _INT32_MAX:
        raise ValueError(f"flash_attention: window {window} outside 0..2^31-1")
    if abs(q_offset) > _INT32_MAX // 2:
        raise ValueError(f"flash_attention: q_offset {q_offset} out of range")
    variant = _variant(q.dtype, d)
    if variant == "wgmma":
        _check_tma(q, k, v, check_base=on_device)
    return variant


def _launch(q, k, v, causal: bool, window: int | None, q_offset: int) -> torch.Tensor:
    """Kernel launch for CUDA tensors; validates everything it passes on."""
    variant = _check(q, k, v, window, q_offset)
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    fn = _build.load("flash_attention").flash_attention_fwd
    out = torch.empty_like(q)  # q's layout: a transposed [B, S, H, D] view stays one
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            b, h, kv, sq, sk, d, int(causal), int(window is not None),
            0 if window is None else window, q_offset, 1.0 / float(d) ** 0.5,
            int(q.dtype == torch.bfloat16), int(variant == "wgmma"), _build.stream_of(q),
        )
        _build.count("flash_attention", variant)
    _build.check(err, "flash_attention")
    return out


def _attention_rows(q, k, v, causal: bool, window: int | None, q_offset: int) -> torch.Tensor:
    """The function the kernel computes, in plain PyTorch: `attention_ref`
    with the rows that see no key set to 0 (attention_ref's softmax over
    all-NEG scores would give them the mean of V)."""
    o = attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    q_pos = q_offset + torch.arange(q.shape[2], device=q.device)
    live = _mask(q_pos, torch.arange(k.shape[2], device=q.device), causal, window).any(-1)
    return torch.where(live[:, None], o, torch.zeros((), dtype=o.dtype, device=o.device))


def flash_attention_backward(q, k, v, do, *, causal: bool = True, window: int | None = None,
                             q_offset: int = 0):
    """(dq, dk, dv) of the flash kernel's function at (q, k, v) for the
    output gradient `do`: the plain backward. Each query chunk's attention
    is recomputed from fp32 copies under autograd (`_attention_rows`) and
    differentiated; dk and dv are summed over the chunks in fp32, and each
    gradient is rounded once to its input's dtype. One chunk holds every
    query up to `_CHUNKED_THRESHOLD` scores, as many rows as fit in it
    above, so the [chunk, Sk] scores bound the memory as
    `attention_chunked`'s chunks bound the forward's. Runs on the device
    of its inputs, the CPU included."""
    sq, sk = q.shape[2], k.shape[2]
    q_chunk = sq if sq * sk <= _CHUNKED_THRESHOLD else max(1, _CHUNKED_THRESHOLD // sk)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kf = k.detach().float().requires_grad_()
    vf = v.detach().float().requires_grad_()
    with torch.enable_grad(), span("flash.backward", sq=sq, sk=sk):
        for a in range(0, sq, q_chunk):
            qc = q[:, :, a:a + q_chunk].detach().float().requires_grad_()
            o = _attention_rows(qc, kf, vf, causal, window, q_offset + a)
            gq, gk, gv = torch.autograd.grad(o, (qc, kf, vf), do[:, :, a:a + q_chunk].float())
            dq[:, :, a:a + q_chunk] = gq
            dk += gk
            dv += gv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@torch.library.custom_op(
    "repro_torch::flash_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int? window, int q_offset) -> Tensor",
)
def _flash_op(q, k, v, causal, window, q_offset):
    """The kernel as a dispatcher op: the launch, for every device type (a
    tensor that is not on a CUDA device raises in `_launch`)."""
    return _launch(q, k, v, causal, window, q_offset)


def _plain(q, k, v, causal: bool, window: int | None, q_offset: int) -> torch.Tensor:
    """The CPU route: `attention_ref`, streaming past `_CHUNKED_THRESHOLD`."""
    if q.shape[2] * k.shape[2] > _CHUNKED_THRESHOLD:
        return attention_chunked(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)


@_flash_op.register_kernel("cpu")
def _flash_cpu(q, k, v, causal, window, q_offset):
    """The op on CPU tensors (a CPU DTensor's local tensors): the plain route."""
    return _plain(q, k, v, causal, window, q_offset)


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window, q_offset):
    """q's shape, dtype and layout, after the launch rules that need no data."""
    _check(q, k, v, window, q_offset, on_device=False)
    return torch.empty_like(q)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, q_offset = inputs
    ctx.save_for_backward(q, k, v)
    ctx.attn = (causal, window, q_offset)
    # A DTensor call ran the kernel on local tensors laid out as its output.
    ctx.placements = output.placements if isinstance(output, DTensor) else None


def _flash_op_backward(ctx, do):
    q, k, v = ctx.saved_tensors
    causal, window, q_offset = ctx.attn
    if ctx.placements is None:
        dq, dk, dv = flash_attention_backward(q, k, v, do, causal=causal, window=window, q_offset=q_offset)
        return dq, dk, dv, None, None, None
    # Every (batch, head) slab of attention is independent: each rank runs
    # the plain backward on its local slabs, in the layout the forward ran.
    mesh, pl = q.device_mesh, ctx.placements
    local = [t.redistribute(mesh, pl).to_local() for t in (q, k, v, do)]
    grads = flash_attention_backward(*local, causal=causal, window=window, q_offset=q_offset)
    return (*(DTensor.from_local(g, mesh, pl, run_check=False, shape=t.shape, stride=_contiguous(t.shape))
              for g, t in zip(grads, (q, k, v))), None, None, None)


def _contiguous(shape) -> tuple:
    """Row-major strides of `shape` (the plain backward's gradients are
    contiguous; a batch split may be uneven, so the global shape is given)."""
    stride, n = [], 1
    for size in reversed(shape):
        stride.append(n)
        n *= size
    return tuple(reversed(stride))


_flash_op.register_autograd(_flash_op_backward, setup_context=_setup_context)


def _heads_split_ok(h: int, kv: int, mesh_sizes) -> bool:
    """True iff some set of mesh dims can split the heads and every set
    that DTensor would let split the Kv heads (a product n <= Kv) divides
    both H and Kv: each rank then holds H/n query heads over exactly its
    Kv/n kv heads, the grouping h // (H // Kv) the kernel applies to its
    local heads."""
    dims = [s for s in mesh_sizes if s > 1]
    ok = False
    for mask in range(1, 1 << len(dims)):
        n = math.prod(s for i, s in enumerate(dims) if mask >> i & 1)
        if n > kv:
            continue  # DTensor splits no dim over more ranks than it has rows
        if h % n or kv % n:
            return False
        ok = True
    return ok


@register_sharding(torch.ops.repro_torch.flash_attention.default)
def _flash_sharding(q, k, v, causal, window, q_offset):
    """The op's placements on one mesh dim, output first: q, k, v and the
    output all Shard(0) (batch), all Shard(1) (heads, where
    `_heads_split_ok`), or all Replicate(). A query split on heads beside
    replicated keys is never offered: each rank's kernel would pair its
    local query head h with local kv head h // (H_local // Kv), another
    kv head than the global grouping's."""
    none = [None, None, None]
    out = [([Replicate()], [Replicate()] * 3 + none), ([Shard(0)], [Shard(0)] * 3 + none)]
    if _heads_split_ok(q.shape[1], k.shape[1], q.mesh.shape):
        out.append(([Shard(1)], [Shard(1)] * 3 + none))
    return out


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_attention_flop(q_shape, k_shape, *args, **kwargs) -> int:
    """4 * B * H * Sq * Sk * D: QK^T and PV over every (query, key) pair."""
    b, h, sq, d = q_shape
    return 4 * b * h * sq * k_shape[2] * d


def flash_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Kv, Sk, D]
    v: torch.Tensor,  # [B, Kv, Sk, D]
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Softmax attention, q head h against kv head h // (H // Kv); the
    output has q's shape, dtype and layout. Differentiable on both routes.
    A CPU DTensor goes through the op, whose sharding rule lays it out and
    whose CPU implementation runs the plain route on each rank's local
    tensors."""
    plain = not any(isinstance(t, DTensor) for t in (q, k, v))
    if plain and q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return _plain(q, k, v, causal, window, q_offset)
    if plain and q.device.type != "meta":
        # A plain CUDA call is checked, and its library loaded, before the
        # dispatcher sees it; a DTensor call is checked on each rank's local
        # tensors, in the launch.
        _check(q, k, v, window, q_offset)
        _build.load("flash_attention")
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, window, q_offset)
