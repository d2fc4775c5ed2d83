"""Multi-pod dry run: check that the distribution config is coherent with
no hardware (the JAX package's `launch/dryrun.py`).

For every (architecture x input-shape) cell and each production mesh
(single-pod 16x16, multi-pod 2x16x16), the step the cell runs (train,
prefill or decode) is run on `meta` tensors, its input specs
(`launch/steps.py`) with the sharding rules' specs
(`distributed/sharding.py`), under `launch/op_cost.py`, and the record
holds:

  * flops, bytes_accessed, peak_bytes: the step's op-level cost, global
    (the whole step as one device would run it). FLOPs equal the count of
    the same step run on the card; the flash backward recomputes the
    forward's scores, 4 * B * H * Sq * Sk * D a call over what JAX counts.
  * per_device_argument_gib and memory.argument_bytes: parameters,
    optimizer state, caches and batch per device under their specs, as
    JAX computes them.
  * flops_per_device, collective_bytes ({JAX's kind name: result bytes})
    and memory.peak_bytes / memory.temp_bytes (the peak less the
    arguments), per device: on a mesh of more than one device the step
    runs a second time, inside `launch.mesh.fake_mesh` (a `fake` process
    group of the mesh's size), on DTensors laid out by the specs and under
    `activation_sharding`, and these are rank 0's counts; JAX reads them
    out of the SPMD partitioner's HLO. On a one-device mesh they are the
    global counts and collective_bytes is {}.

These per-device numbers are DTensor's: the layouts it picks for the ops
between `shard`'s constraints, which are not the SPMD partitioner's (only
the dense decode's per-device FLOPs equal JAX's, and the MoE decode's come
within 1% above them, each model rank computing its groups' router product
whole; PERF.md, open questions). The MoE
layers run one local region a layer (`models/layers.py`, `_moe_on_mesh`):
its ops are rank 0's own groups and expert slices, its collectives the
gathers of the router and the expert weights into the region and the
reduction of its output (and their reduce-scatters in the backward).
DTensor on the fake group's CPU mesh re-lays a Shard(i) -> Shard(j)
redistribute as all-gather + chunk (gloo has no all-to-all), where a CUDA
mesh runs an all-to-all: such bytes count as "all-gather"
(`ALL_TO_ALL_NOTE`, on every mesh record). The MoE region itself makes
no such re-lay; the layers around it may.

A failure of the DTensor trace leaves the cell "ok" with its global
numbers and records the failure as `mesh_error`, the per-device numbers
null (never zero), and the CLI counts it and exits 1: every applicable
cell of the matrix runs on the mesh. A failure of the global trace fails
the cell (status "error").

The run stays on the host by design, as JAX's runs on fake CPU devices: it
takes no device and allocates nothing on the card.

Results are written as JSON under results/dryrun_torch/ (never under
results/dryrun/, the JAX package's).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--debug-mesh]
  python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import time
import traceback
from pathlib import Path

import torch

from ..configs import ARCHS, get_config
from ..distributed.sharding import (
    ShardingRules,
    batch_axes_size,
    batch_pspec_for,
    cache_pspecs,
    distribute_params,
    distribute_tree,
    param_pspecs,
)
from ..models.config import SHAPES, ShapeConfig, shape_applicable
from . import op_cost
from . import steps as St
from .mesh import MeshShape, fake_mesh, make_debug_mesh, make_production_mesh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

_MISSING_RULE = re.compile(r"Operator (\S+) does not have a sharding strategy registered")


def missing_rule(error: str | None) -> str | None:
    """The op a mesh error says DTensor has no sharding rule for, else None."""
    m = _MISSING_RULE.search(error or "")
    return m.group(1) if m else None


ALL_TO_ALL_NOTE = ("all-to-all: DTensor on the fake group's CPU mesh re-lays Shard(i) -> "
                   "Shard(j) as all-gather + chunk, counted as all-gather")


def _shape(shape: str | ShapeConfig) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def build_cell(arch: str, shape_name: str | ShapeConfig, mesh: MeshShape, rules: ShardingRules,
               microbatches: int = 1, vocab_chunks: int = 0,
               cache_layout: str | None = None, moe_groups: int = -1,
               seq_shard: bool = False, remat: bool | None = None,
               no_fsdp: bool = False, quant_int8: bool = False, device_mesh=None):
    """(step_fn, arg_specs, arg_pspecs) for a cell: the step, its arguments
    as `meta` tensors (a tuple) and their partition specs (a list of
    congruent trees; a spec itself is a tuple). With `device_mesh` (a
    `DeviceMesh` of `mesh`'s names and sizes) the arguments are DTensors
    laid out by their specs and the step runs over that mesh."""
    cfg = get_config(arch)
    if vocab_chunks:
        cfg = dataclasses.replace(cfg, vocab_chunking=vocab_chunks)
    if moe_groups < 0:  # auto: one dispatch group per data shard
        moe_groups = batch_axes_size(mesh, rules)
    cfg = dataclasses.replace(cfg, moe_groups=moe_groups)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if seq_shard:
        rules = dataclasses.replace(rules, seq_shard_residual=True)
    if no_fsdp:
        rules = dataclasses.replace(rules, fsdp=False)
    shape = _shape(shape_name)

    def batch_of(specs):
        return {k: batch_pspec_for(mesh, rules, shape.global_batch) for k in specs}

    on_mesh = {} if device_mesh is None else {"mesh": device_mesh, "rules": rules}

    def laid_out(args, pspecs):
        """The arguments as DTensors over `device_mesh` (as they are without one)."""
        if device_mesh is None:
            return args
        return tuple(distribute_params(a, device_mesh, sp) if isinstance(a, torch.nn.Module)
                     else distribute_tree(a, device_mesh, sp) for a, sp in zip(args, pspecs, strict=True))

    if shape.kind == "train":
        step = St.make_train_step(cfg, microbatches=microbatches, **on_mesh)
        p_specs = St.param_specs(cfg)
        o_specs = St.opt_specs(cfg)
        b_specs = St.batch_specs(cfg, shape)
        p_sh = param_pspecs(cfg, p_specs, mesh, rules)
        o_sh = {"mu": p_sh, "nu": p_sh, "step": ()}
        pspecs = [p_sh, o_sh, batch_of(b_specs)]
        return step, laid_out((p_specs, o_specs, b_specs), pspecs), pspecs

    scfg = St.serve_config(cfg)
    if quant_int8:
        scfg = dataclasses.replace(scfg, quantize_int8=True)
    if cache_layout:
        rules = dataclasses.replace(rules, cache_layout=cache_layout)
    p_specs = St.param_specs(scfg)
    p_sh = param_pspecs(scfg, p_specs, mesh, rules)
    if shape.kind == "prefill":
        step = St.make_prefill_step(scfg, shape.seq_len, **on_mesh)
        b_specs = St.batch_specs(scfg, shape)
        pspecs = [p_sh, batch_of(b_specs)]
        return step, laid_out((p_specs, b_specs), pspecs), pspecs

    # decode
    serve_step = St.make_serve_step(scfg, **on_mesh)

    def step(params, caches, token, pos):
        # JAX's step takes the position as an int32 scalar; the port's as an
        # int. A `meta` scalar holds no value, and the step's cost does not
        # depend on it: decode at the last position the cache holds.
        return serve_step(params, caches, token, shape.seq_len - 1)

    c_specs = St.cache_specs(scfg, shape)
    t_spec = St.batch_specs(scfg, shape)["token"]
    pos_spec = torch.empty((), dtype=torch.int32, device="meta")
    c_sh = cache_pspecs(scfg, c_specs, mesh, rules)
    t_sh = batch_pspec_for(mesh, rules, shape.global_batch)
    pspecs = [p_sh, c_sh, t_sh, ()]
    args = laid_out((p_specs, c_specs, t_spec), pspecs[:3]) + (pos_spec,)
    return step, args, pspecs


def _leaves(tree) -> list:
    """Tensors of an argument tree in order: a module's parameters by
    name, dicts by key, lists and tuples in order."""
    if isinstance(tree, torch.nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [t for v in tree for t in _leaves(v)]


def _spec_leaves(tree) -> list:
    """Partition specs congruent with `_leaves` (a spec is a tuple whose
    entries are names, None or tuples of names)."""
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _spec_leaves(v)]
    if isinstance(tree, list):
        return [s for v in tree for s in _spec_leaves(v)]
    return [tree]


def _sharded_arg_bytes(arg_specs, arg_pspecs, mesh: MeshShape) -> float:
    """Per-device bytes of all inputs under their specs."""
    specs, pspecs = _leaves(arg_specs), _spec_leaves(arg_pspecs)
    if len(specs) != len(pspecs):
        raise ValueError(f"{len(specs)} arguments against {len(pspecs)} partition specs")
    total = 0.0
    for spec, ps in zip(specs, pspecs):
        nbytes = math.prod(spec.shape) * spec.element_size()
        shards = 1
        for entry in ps:
            for axis in entry if isinstance(entry, tuple) else (entry,):
                if axis is not None:
                    shards *= mesh.shape[axis]
        total += nbytes / shards
    return total


def run_cell(arch: str, shape_name: str | ShapeConfig, *, multi_pod: bool = False,
             debug_mesh: bool = False, microbatches: int = 1,
             vocab_chunks: int = 0, cache_layout: str | None = None,
             moe_groups: int = -1, seq_shard: bool = False,
             remat: bool | None = None, no_fsdp: bool = False,
             quant_int8: bool = False, mesh: MeshShape | None = None,
             save: bool = True, tag: str = "", out_dir: Path = RESULTS_DIR) -> dict:
    """One cell's record. `mesh` overrides the production or debug mesh
    (e.g. `make_debug_mesh(n_devices=1, model=1)`, the one-device mesh)."""
    cfg = get_config(arch)
    shape = _shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    if mesh is None:
        mesh = make_debug_mesh(multi_pod=multi_pod) if debug_mesh else make_production_mesh(multi_pod=multi_pod)
    record = {
        "arch": arch, "shape": shape.name, "mesh": mesh.name,
        "multi_pod": multi_pod, "tag": tag,
        "microbatches": microbatches, "vocab_chunks": vocab_chunks,
        "cache_layout": cache_layout,
    }
    if not ok:
        record.update(status="skipped", reason=reason)
        if save:
            _save(record, out_dir)
        return record

    rules = ShardingRules(pod_axis="pod" if "pod" in mesh.axis_names else None)
    kw = dict(microbatches=microbatches, vocab_chunks=vocab_chunks, cache_layout=cache_layout,
              moe_groups=moe_groups, seq_shard=seq_shard, remat=remat, no_fsdp=no_fsdp,
              quant_int8=quant_int8)
    t0 = time.time()
    try:
        step, arg_specs, arg_pspecs = build_cell(arch, shape, mesh, rules, **kw)
        t_build = time.time() - t0
        cost = op_cost.analyze(step, *arg_specs)
        t_trace = time.time() - t0 - t_build
        arg_bytes = _sharded_arg_bytes(arg_specs, arg_pspecs, mesh)
        warnings = list(cost["warnings"])
        per_device, mesh_error = cost, None
        if mesh.size > 1:
            warnings.append(ALL_TO_ALL_NOTE)
            try:
                with fake_mesh(mesh) as device_mesh:
                    step_d, args_d, _ = build_cell(arch, shape, mesh, rules, device_mesh=device_mesh, **kw)
                    per_device = op_cost.analyze(step_d, *args_d)
            except Exception as e:  # the global numbers stand; the record names the failure
                per_device, mesh_error = None, f"{type(e).__name__}: {e}"
                record.update(mesh_error=mesh_error, mesh_trace=traceback.format_exc()[-2000:])
        t_mesh = time.time() - t0 - t_build - t_trace

        def dev(value):
            return None if per_device is None else value(per_device)

        record.update(
            status="ok",
            build_s=round(t_build, 2),
            trace_s=round(t_trace, 2),
            mesh_trace_s=round(t_mesh, 2),
            flops=cost["flops"],
            bytes_accessed=cost["bytes"],
            peak_bytes=cost["peak_bytes"],
            flops_per_device=dev(lambda c: c["flops"]),
            bytes_accessed_per_device=dev(lambda c: c["bytes"]),
            op_warnings=warnings,
            memory={
                "argument_bytes": arg_bytes,
                "peak_bytes": dev(lambda c: float(c["peak_bytes"])),
                "temp_bytes": dev(lambda c: float(c["peak_bytes"] - arg_bytes)),
            },
            collective_bytes=dev(lambda c: {k: float(v) for k, v in c["collectives"].items()}),
            per_device_argument_gib=round(arg_bytes / 2**30, 3),
            n_devices=mesh.size,
        )
    except Exception as e:
        record.update(status="error", error=f"{type(e).__name__}: {e}", trace=traceback.format_exc()[-2000:])
    if save:
        _save(record, out_dir)
    return record


def _save(record: dict, out_dir: Path = RESULTS_DIR):
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"-{record['tag']}" if record.get("tag") else ""
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}{tag}.json"
    (out_dir / name).write_text(json.dumps(record, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--debug-mesh", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--vocab-chunks", type=int, default=0)
    ap.add_argument("--cache-layout", choices=["seq", "heads"], default=None)
    ap.add_argument("--moe-groups", type=int, default=-1)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--quant-int8", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", type=Path, default=RESULTS_DIR,
                    help="where the records go (default results/dryrun_torch/)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in ARCHS for shape in SHAPES]
    elif args.arch and not args.shape:
        cells = [(args.arch, shape) for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_skip = n_err = n_mesh_err = 0
    for arch, shape in cells:
        for mp in meshes:
            r = run_cell(
                arch, shape, multi_pod=mp, debug_mesh=args.debug_mesh,
                microbatches=args.microbatches, vocab_chunks=args.vocab_chunks,
                cache_layout=args.cache_layout, moe_groups=args.moe_groups,
                seq_shard=args.seq_shard, no_fsdp=args.no_fsdp,
                quant_int8=args.quant_int8,
                remat=(False if args.no_remat else None), tag=args.tag, out_dir=args.out_dir,
            )
            status = r["status"]
            n_ok += status == "ok"
            n_skip += status == "skipped"
            n_err += status == "error"
            n_mesh_err += "mesh_error" in r
            if status == "ok":
                per_device = (f"mesh_error={r['mesh_error'][:160]}" if "mesh_error" in r
                              else f"coll={sum(r['collective_bytes'].values()) / 2**20:.1f}MiB")
                print(
                    f"OK    {arch:22s} {shape:12s} {r['mesh']:8s} "
                    f"trace={r['trace_s']:7.1f}s flops={r['flops']:.3e} "
                    f"args/dev={r['per_device_argument_gib']:.2f}GiB "
                    f"peak={r['peak_bytes'] / 2**30:.1f}GiB {per_device}",
                    flush=True,
                )
            elif status == "skipped":
                print(f"SKIP  {arch:22s} {shape:12s} {r['mesh']:8s} {r['reason'][:60]}", flush=True)
            else:
                print(f"ERROR {arch:22s} {shape:12s} {r['mesh']:8s} {r['error'][:200]}", flush=True)
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_err} errors, {n_mesh_err} mesh errors")
    return 0 if n_err == n_mesh_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
