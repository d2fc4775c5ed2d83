"""Sharding rules (the JAX package's `distributed/sharding.py`). Two layout
families live here:

1. the serving substrate's parameter, batch and decode-cache partition
   specs over a ("data", "model"[, "pod"]) mesh, its rules as they stand;
2. the fleet control plane's instance-axis layout (`FLEET_AXIS`,
   `fleet_sharding`, `shard_fleet`): a stacked `[B, ...]` problem ensemble
   laid out over a 1-D `DeviceMesh` of ranks, one process a device
   (`launch.mesh.make_fleet_mesh`). Instances never talk to each other, so
   the only collectives of a sharded solve are the engine's one exit flag
   a round (core/engine.py) and the final gather. `fleet/solve.py` wraps
   each rank's lanes with `DTensor.from_local` and checks its outputs with
   `carries_fleet_sharding`, so a layout fallback is never silent.

A partition spec here is a tuple with one entry per tensor dim, as JAX's
`PartitionSpec` lists them: a mesh-axis name, None (replicated), or a tuple
of names for a dim split over several axes; trailing dims left out are
replicated, and () replicates the whole tensor. The substrate rules read a
mesh as `launch.mesh.MeshShape` (axis names and sizes, no devices);
`to_named_shardings` turns specs into DTensor placements over a real
`DeviceMesh`.

Baseline layout of the reference:
  * TP over "model" on the natural tensor-parallel dim of every matmul
    (attention heads, FFN hidden, experts, vocab);
  * FSDP over "data" on the other large dim (params and Adam moments fully
    sharded);
  * batch over ("pod", "data"); the pod axis is pure data parallelism;
  * decode KV caches: batch over ("pod", "data"), sequence over "model".
A dim is only given a mesh axis when the axis size divides it.

The port keeps one module a layer where JAX stacks the layers on axis 0
(`models/convert.py`). `param_pspecs` and `cache_pspecs` therefore run
JAX's rule on the stacked shape ([L] + the layer's shape, where the rule
never shards L) and return its spec without the leading layer entry.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..launch.mesh import MeshShape
from ..models.config import ModelConfig
from ..models.quant import STACKED


# ---------------------------------------------------------------------------
# Fleet control plane: instance-axis layout over a 1-D mesh of ranks
# ---------------------------------------------------------------------------

# The one mesh-dim name the fleet path uses everywhere: launch/mesh.py builds
# the mesh over it, fleet/solve.py lays its lanes out on it, and the sharded
# tests check that outputs still carry it.
FLEET_AXIS = "fleet"


def fleet_pspec() -> tuple:
    """Leading instance axis over the fleet mesh, everything else replicated."""
    return (FLEET_AXIS,)


def fleet_sharding(mesh) -> list:
    """The placements of every `[B, ...]` leaf of a stacked fleet over
    `mesh`: Shard(0) on its fleet dim, Replicate() on any other."""
    if FLEET_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"mesh {mesh.mesh_dim_names} has no {FLEET_AXIS!r} axis; build it "
            "with repro_torch.launch.mesh.make_fleet_mesh"
        )
    return to_placements(mesh, fleet_pspec())


def fleet_lanes(mesh, batch: int) -> slice:
    """The lanes of a `batch`-lane stack that this rank holds under the fleet
    layout: one contiguous block of batch / fleet-size lanes, by the rank's
    coordinate on the fleet dim."""
    size = mesh.size(mesh.mesh_dim_names.index(FLEET_AXIS))
    if batch % size:
        raise ValueError(
            f"a fleet of {batch} lanes does not divide over {size} ranks; pad it with "
            "fleet.pad_batch_to_multiple first"
        )
    coord = mesh.get_local_rank(FLEET_AXIS)
    per = batch // size
    return slice(coord * per, (coord + 1) * per)


def _map_tensors(tree, fn):
    """Apply `fn` to every tensor leaf of a tree of dataclasses, dicts,
    lists and tuples; other leaves (hop bounds, cost kinds) pass."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _map_tensors(getattr(tree, f.name), fn)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def fleet_from_local(tree, mesh):
    """Every tensor leaf of `tree`, this rank's lanes of a fleet, as a
    DTensor of the fleet layout (no data moves)."""
    placements = fleet_sharding(mesh)
    return _map_tensors(tree, lambda x: DTensor.from_local(x, mesh, placements))


def shard_fleet(tree, mesh):
    """Lay every tensor leaf of a stacked fleet out over the fleet layout.

    Every data leaf of a stacked `Problem` / `PadInfo` / `State` is
    `[B, ...]` with B divisible by the fleet size (fleet/solve.py pads with
    inert repeats first), and every rank holds the whole tree (each builds
    the same fleet from the same seed), so no data moves: each leaf becomes
    `DTensor.from_local(leaf[this rank's lanes], mesh, fleet_sharding(mesh))`."""
    return fleet_from_local(_map_tensors(tree, lambda x: x[fleet_lanes(mesh, x.shape[0])]), mesh)


def carries_fleet_sharding(x) -> bool:
    """True iff `x` is a DTensor laid out over a fleet dim of two or more
    ranks with Shard(0) there. The output-side check of the "no silent
    fallback" contract: a plain tensor, a one-rank mesh, or a replicated
    fleet dim all return False."""
    if not isinstance(x, DTensor):
        return False
    names = x.device_mesh.mesh_dim_names or ()
    if FLEET_AXIS not in names:
        return False
    dim = names.index(FLEET_AXIS)
    return x.device_mesh.size(dim) >= 2 and x.placements[dim] == Shard(0)


def to_placements(mesh, spec: tuple) -> list:
    """One partition spec as DTensor placements over `mesh`: Shard(d) on
    every mesh dim the spec names for tensor dim d, Replicate() on the
    rest. A tensor dim split over several axes takes them in mesh order."""
    names = mesh.mesh_dim_names or ()
    placements = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is None:
                continue
            if axis not in names:
                raise ValueError(f"spec {spec} names {axis!r}, not an axis of mesh {names}")
            i = names.index(axis)
            if placements[i] != Replicate():
                raise ValueError(f"spec {spec} uses mesh axis {axis!r} twice")
            placements[i] = Shard(d)
    return placements


def to_named_shardings(mesh, spec_tree):
    """A tree of partition specs (dicts and lists of spec tuples, as
    `param_pspecs` and `cache_pspecs` return) as the same tree of placement
    lists over `mesh`."""
    if isinstance(spec_tree, tuple):
        return to_placements(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: to_named_shardings(mesh, v) for k, v in spec_tree.items()}
    return [to_named_shardings(mesh, v) for v in spec_tree]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: str | None = None  # set when the mesh has a pod dimension
    fsdp: bool = True  # shard the non-TP dim of params over data
    # Decode-cache layout: "seq" shards the KV sequence dim over model,
    # "heads" shards KV heads (falls back to seq when kv % axis != 0).
    cache_layout: str = "seq"
    # Sequence-parallel residual stream: `act.shard(x, "residual")` splits
    # the sequence dim over "model" where its size divides it.
    seq_shard_residual: bool = False
    # 2D ("data"+"model") tensor parallelism for serving (hillclimb option).
    serve_2d_tp: bool = False


def _axis_size(mesh, name: str | None) -> int:
    if name is None:
        return 1
    return mesh.shape[name]


def _maybe(mesh, dim_size, axis):
    """Assign `axis` to a dim only when it divides evenly."""
    if axis is None:
        return None
    return axis if dim_size % _axis_size(mesh, axis) == 0 else None


def batch_pspec(rules: ShardingRules) -> tuple:
    if rules.pod_axis:
        return ((rules.pod_axis, rules.data_axis),)
    return (rules.data_axis,)


def batch_axes_size(mesh, rules: ShardingRules) -> int:
    n = _axis_size(mesh, rules.data_axis)
    if rules.pod_axis:
        n *= _axis_size(mesh, rules.pod_axis)
    return n


def batch_pspec_for(mesh, rules: ShardingRules, batch: int) -> tuple:
    """Replicate when the global batch doesn't divide the DP axes (e.g. the
    batch=1 long-context decode cell)."""
    if batch % batch_axes_size(mesh, rules) == 0:
        return batch_pspec(rules)
    return ()


def _param_rule(path: str, shape, mesh, rules: ShardingRules, cfg: ModelConfig) -> tuple:
    """JAX's rule for the leaf at `path` ("blocks/attn/wq") of JAX's
    (stacked) `shape`."""
    if path.endswith("/__s"):
        return ()  # per-tensor quantization scale: replicated scalar
    if path.endswith("/__q"):
        path = path[: -len("/__q")]  # int8 payload shards like its parent
    d_ax = rules.data_axis if rules.fsdp else None
    m_ax = rules.model_axis
    dims = len(shape)

    def spec(*axes):
        return tuple(axes) + (None,) * (dims - len(axes))

    # ---- embedding / head ----
    if path.endswith("embed/embed"):
        return spec(_maybe(mesh, shape[0], m_ax), _maybe(mesh, shape[1], d_ax))
    if path.endswith("embed/lm_head"):
        return spec(_maybe(mesh, shape[0], d_ax), _maybe(mesh, shape[1], m_ax))
    if path.endswith("embed/frontend_proj"):
        return spec(None, _maybe(mesh, shape[1], m_ax))

    # ---- attention (leading stacked-layer dim) ----
    if "/attn/" in path or "/self_attn/" in path or "/cross_attn/" in path:
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "wq":  # [L, d, H, hd]
            h_ax = _maybe(mesh, shape[2], m_ax)
            return spec(None, _maybe(mesh, shape[1], d_ax), h_ax)
        if leaf in ("wk", "wv"):  # [L, d, Kv, hd]
            kv_ax = _maybe(mesh, shape[2], m_ax)
            if kv_ax is None:
                # few KV heads: row-parallel on d instead (psum after)
                return spec(None, _maybe(mesh, shape[1], m_ax), None)
            return spec(None, _maybe(mesh, shape[1], d_ax), kv_ax)
        if leaf == "wo":  # [L, H, hd, d]
            return spec(None, _maybe(mesh, shape[1], m_ax), None, _maybe(mesh, shape[3], d_ax))
        if leaf == "bq":  # [L, H, hd]
            return spec(None, _maybe(mesh, shape[1], m_ax))
        if leaf in ("bk", "bv"):
            return spec(None, _maybe(mesh, shape[1], m_ax))

    # ---- dense / shared MLP ----
    if path.rsplit("/", 1)[-1] in ("wi", "wg") and "/mlp" in path or "/shared/" in path and path.endswith(("wi", "wg")):
        return spec(None, _maybe(mesh, shape[1], d_ax), _maybe(mesh, shape[2], m_ax)) if dims == 3 else ()
    if path.endswith("/mlp/wo") or path.endswith("/shared/wo"):
        return spec(None, _maybe(mesh, shape[1], m_ax), _maybe(mesh, shape[2], d_ax))

    # ---- MoE ----
    if path.endswith("/moe/router"):
        return spec(None, _maybe(mesh, shape[1], d_ax), None)
    if path.endswith(("/moe/wi_e", "/moe/wg_e")):  # [L, E, d, ff]
        e_ax = _maybe(mesh, shape[1], m_ax)
        if e_ax is not None:
            return spec(None, e_ax, _maybe(mesh, shape[2], d_ax), None)
        return spec(None, None, _maybe(mesh, shape[2], d_ax), _maybe(mesh, shape[3], m_ax))
    if path.endswith("/moe/wo_e"):  # [L, E, ff, d]
        e_ax = _maybe(mesh, shape[1], m_ax)
        if e_ax is not None:
            return spec(None, e_ax, None, _maybe(mesh, shape[3], d_ax))
        return spec(None, None, _maybe(mesh, shape[2], m_ax), _maybe(mesh, shape[3], d_ax))
    if path.endswith("/moe/shared_gate"):
        return spec(None, _maybe(mesh, shape[1], d_ax), None)

    # ---- SSM ----
    if path.endswith("/ssm/in_proj"):  # [L, d, K]
        return spec(None, _maybe(mesh, shape[1], m_ax), None)
    if path.endswith("/ssm/out_proj"):  # [L, din, d]
        return spec(None, _maybe(mesh, shape[1], m_ax), None)
    if path.endswith("/ssm/conv_w") or path.endswith("/ssm/conv_b"):
        return ()

    # norms / scalars / small vectors: replicated
    return ()


def _unstack(spec: tuple) -> tuple:
    """A stacked leaf's spec without its layer entry."""
    return spec[1:] if spec else ()


def param_pspecs(cfg: ModelConfig, params: nn.Module, mesh, rules: ShardingRules) -> dict:
    """{parameter name: spec} for every leaf of `params` (a `ParamTree`,
    e.g. `launch.steps.param_specs`). A leaf of a layer stack gets the spec
    JAX gives the stacked leaf, without the layer entry."""
    stacks = {name: len(m) for name, m in params.named_children() if name in STACKED}
    out = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        if parts[0] in stacks:
            path = "/".join([parts[0], *parts[2:]])  # JAX's path has no layer index
            out[name] = _unstack(_param_rule(path, (stacks[parts[0]], *p.shape), mesh, rules, cfg))
        else:
            out[name] = _param_rule("/".join(parts), tuple(p.shape), mesh, rules, cfg)
    return out


def cache_pspecs(cfg: ModelConfig, caches: list, mesh, rules: ShardingRules) -> list:
    """Decode caches, a dict a layer: JAX's rule on the stacked leaves
    ([L, B, Kv, C, hd] attention; [L, B, nh, hp, n] SSM states), without
    the layer entry."""
    nb = batch_axes_size(mesh, rules)
    m_ax = rules.model_axis
    n_layers = len(caches)

    def b_of(dim_size):
        if dim_size % nb != 0:
            return None
        return (rules.pod_axis, rules.data_axis) if rules.pod_axis else rules.data_axis

    def rule(path: str, shape) -> tuple:
        dims = len(shape)
        if path.endswith(("attn/k", "attn/v")) or path.endswith(("cross_k", "cross_v")):
            # [L, B, Kv, C, hd]
            b_ax = b_of(shape[1])
            if rules.cache_layout == "heads" and shape[2] % _axis_size(mesh, m_ax) == 0:
                return (None, b_ax, m_ax, None, None)
            return (None, b_ax, None, _maybe(mesh, shape[3], m_ax), None)
        if path.endswith("ssm/state"):  # [L, B, nh, hp, n]
            return (None, b_of(shape[1]), _maybe(mesh, shape[2], m_ax), None, None)
        if path.endswith("ssm/conv"):  # [L, B, cw-1, conv_dim]
            return (None, b_of(shape[1]), None, _maybe(mesh, shape[3], m_ax))
        if dims >= 2:
            return (None, b_of(shape[1]))
        return ()

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
        return _unstack(rule(prefix, (n_layers, *tree.shape)))

    return [walk(layer, "") for layer in caches]


# ---------------------------------------------------------------------------
# Laying a model, its batch and its caches out over a DeviceMesh
# ---------------------------------------------------------------------------
def _distribute(t: torch.Tensor, mesh, spec: tuple):
    """`t`, the same on every rank, as a DTensor of `spec` over `mesh`: each
    rank keeps its own shard and nothing is sent (on `meta` too)."""
    return distribute_tensor(t, mesh, to_placements(mesh, spec), src_data_rank=None)


def distribute_params(params: nn.Module, mesh, specs: dict) -> nn.Module:
    """Lay every parameter of `params` (a `ParamTree`) out by `specs`
    ({name: spec}, `param_pspecs`), in place: each leaf becomes a DTensor
    parameter under the same module and name, with its `requires_grad`.
    Every rank must hold the same values (one seed). Returns `params`."""
    modules = dict(params.named_modules())
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        d = _distribute(p.detach(), mesh, specs[name])
        setattr(modules[owner], leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return params


def distribute_tree(tree, mesh, specs):
    """A tree of tensors (dicts and lists) laid out by the congruent tree
    of specs, as new DTensors."""
    if isinstance(tree, torch.Tensor):
        return _distribute(tree, mesh, specs)
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, specs[k]) for k, v in tree.items()}
    return [distribute_tree(v, mesh, s) for v, s in zip(tree, specs, strict=True)]


def distribute_batch(batch: dict, mesh, rules: ShardingRules) -> dict:
    """Every leaf of a batch (`[B, ...]`, the same global batch on every
    rank) over the batch axes, replicated where B does not divide them
    (`batch_pspec_for`)."""
    shape = MeshShape.of(mesh)
    return {k: _distribute(t, mesh, batch_pspec_for(shape, rules, t.shape[0])) for k, t in batch.items()}


def distribute_caches(cfg: ModelConfig, caches: list, mesh, rules: ShardingRules) -> list:
    """The decode caches (a dict a layer) laid out by `cache_pspecs`."""
    return distribute_tree(caches, mesh, cache_pspecs(cfg, caches, MeshShape.of(mesh), rules))
