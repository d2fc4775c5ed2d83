"""GPipe-style pipeline parallelism over a mesh axis (the JAX package's
`distributed/pipeline.py`), one process a stage.

Each rank holds one stage: a contiguous block of layers, `stage_params[s]`
for its coordinate s on the pipeline axis. The classic skewed schedule runs
M + P - 1 ticks; at tick t, stage s runs microbatch t - s, and activations
move one hop a tick, point to point (`batch_isend_irecv`), with no
wrap-around send into stage 0:

    tick:       0    1    2    3    4   (M=3, P=3)
    stage 0:   mb0  mb1  mb2   -    -
    stage 1:    -   mb0  mb1  mb2   -
    stage 2:    -    -   mb0  mb1  mb2

A stage that holds no microbatch at a tick computes nothing (JAX computes
and masks it to zeros). The last stage's outputs are then broadcast over
the axis, so every rank returns them: bitwise JAX's `psum` of the other
stages' zeros and the last stage's values.

The wrapper is model-agnostic: `stage_fn(stage_params, x) -> y` applies one
stage, and y has x's shape and dtype (the activation that crosses the
hop). Held to the sequential application of all stages, and to JAX's
`pipeline_apply`, in `tests/test_torch_pipeline.py`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import solve_device
from .sharding import _map_tensors


def pipeline_apply(stage_fn, stage_params, x_microbatches: torch.Tensor, *, mesh, axis: str = "pod",
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """Run a P-stage pipeline over the `axis` dim of `mesh` (a `DeviceMesh`
    of the default process group, on `device`, where `x_microbatches`
    lives; a CUDA request without a GPU raises).

    stage_params   : tree of tensors with leading dim P (stage-major); this
                     rank takes entry `mesh.get_local_rank(axis)`
    x_microbatches : [M, mb, ...] microbatched inputs, the same on every rank
    Returns the [M, mb, ...] outputs of the last stage on every rank.
    """
    dev = solve_device(x_microbatches.device, device)
    if mesh.device_type != dev.type:
        raise ValueError(f"pipeline_apply: a {mesh.device_type} mesh cannot run on {dev}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"pipeline_apply: mesh {mesh.mesh_dim_names} has no {axis!r} axis")
    if mesh.get_coordinate() is None:
        raise ValueError(f"pipeline_apply: rank {dist.get_rank()} is not in the mesh")
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)

    def local(a):
        if a.shape[0] != n_stages:
            raise ValueError(f"pipeline_apply: stage_params leaf of leading dim {a.shape[0]}, "
                             f"the {axis!r} axis has {n_stages} stages")
        return a[stage]

    p_local = _map_tensors(stage_params, local)
    xs = x_microbatches
    m = xs.shape[0]
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) if stage < n_stages - 1 else None
    outputs = torch.zeros_like(xs)
    carry = None
    for t in range(m + n_stages - 1):
        y = None
        if 0 <= t - stage < m:
            y = stage_fn(p_local, xs[t] if stage == 0 else carry)
            if y.shape != xs.shape[1:] or y.dtype != xs.dtype:
                raise ValueError(f"pipeline_apply: stage_fn gave {tuple(y.shape)} {y.dtype}, the "
                                 f"microbatch is {tuple(xs.shape[1:])} {xs.dtype}")
            if stage == n_stages - 1:
                outputs[t - stage] = y
        # Ship one hop forward: stage s sends what it computed at this tick,
        # stage s + 1 receives it when stage s held a microbatch.
        ops = []
        if nxt is not None and y is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
        if prev is not None and 0 <= t - (stage - 1) < m:
            carry = torch.empty_like(xs[0])
            ops.append(dist.P2POp(dist.irecv, carry, prev, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    if n_stages > 1:
        dist.broadcast(outputs, src=dist.get_global_rank(group, n_stages - 1), group=group)
    return outputs
