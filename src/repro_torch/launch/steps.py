"""Step functions (the JAX package's `launch/steps.py`):

train_step  : forward loss -> grads -> global-norm clip -> AdamW, optionally
              with the gradient accumulated in fp32 over `microbatches`
              (an activation-memory lever)
prefill_step: full-prompt forward building the caches + last logits
serve_step  : one-token decode against the caches

The train step runs where the parameters live; `torch.autograd.grad` takes
the place of `jax.value_and_grad`. Given a `DeviceMesh` (`mesh=`, with
`rules=`), each step runs inside `distributed.act.activation_sharding` on
parameters, optimizer state, batch and caches laid out as DTensors
(`distributed.sharding.distribute_params` and friends), as JAX's launchers
run its steps under `activation_sharding`.

The input specs (`batch_specs`, `param_specs`, `opt_specs`, `cache_specs`)
are `meta` tensors: JAX's `ShapeDtypeStruct` stand-ins, with its shapes
and dtypes, in the port's layout (one module, or cache dict, a layer where
JAX stacks the layers on axis 0; `models/convert.py`). The dry run
(`launch/dryrun.py`) runs the steps on them.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.distributed.tensor import DTensor, Shard

from ..distributed.act import activation_sharding
from ..distributed.sharding import ShardingRules
from ..models import model as M
from ..models.config import ModelConfig, ShapeConfig
from ..models.quant import quantize_params
from ..optim import adamw_update, clip_by_global_norm

_META = torch.device("meta")


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no data)
# ---------------------------------------------------------------------------
def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch of a step of `shape`: int32 tokens, or bf16 features with
    int32 labels (frontend archs) or decoder tokens (encoder-decoder); one
    int32 token a sequence for decode (its cache is separate state)."""
    b, s = shape.global_batch, shape.seq_len

    def spec(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=_META)

    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            return {"feats": spec(b, s, cfg.frontend_dim, dtype=torch.bfloat16), "dec_tokens": spec(b, s)}
        if cfg.frontend != "none":
            return {"feats": spec(b, s, cfg.frontend_dim, dtype=torch.bfloat16), "labels": spec(b, s)}
        return {"tokens": spec(b, s)}
    return {"token": spec(b, 1)}


def param_specs(cfg: ModelConfig) -> M.ParamTree:
    """The model on `meta` (int8 leaves when `cfg.quantize_int8`)."""
    params = M.init_params(cfg, device=_META)
    return quantize_params(params) if cfg.quantize_int8 else params


def opt_specs(cfg: ModelConfig) -> dict:
    """AdamW state on `meta`: fp32 moments keyed by parameter name and the
    int32 step, as `adamw_init` builds it."""
    named = dict(param_specs(cfg).named_parameters())

    def zeros():
        return {n: torch.empty(p.shape, dtype=torch.float32, device=_META) for n, p in named.items()}

    return {"mu": zeros(), "nu": zeros(), "step": torch.empty((), dtype=torch.int32, device=_META)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> list:
    """The decode caches of `shape` on `meta` (a dict a layer)."""
    return M.init_caches(cfg, shape.global_batch, shape.seq_len, device=_META)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def value_and_grad(cfg: ModelConfig, params: M.ParamTree, batch: dict):
    """(loss, {name: gradient}) of `loss_fn` at `params`; a leaf the loss
    does not reach gets a zero gradient, as in JAX."""
    leaves = M.trainable(params)
    loss = M.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(leaves, grads))


def _in_mesh(mesh, rules):
    """The context a step runs in: `activation_sharding` over `mesh`
    (rules with a pod axis where the mesh has one, unless given), or none."""
    if mesh is None:
        return contextlib.nullcontext
    if rules is None:
        rules = ShardingRules(pod_axis="pod" if "pod" in mesh.mesh_dim_names else None)
    return lambda: activation_sharding(mesh, rules)


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor metric as the plain tensor every rank agrees on."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4, grad_clip: float = 1.0,
                    microbatches: int = 1, mesh=None, rules: ShardingRules | None = None):
    """train_step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}). `params` (a `ParamTree`) is updated in place and
    returned; the optimizer state is new, as JAX's. With `microbatches` >
    1 every batch leaf is cut into that many slices along axis 0, their
    gradients summed in fp32 in order and divided by the count, and the
    loss is the mean of theirs. On a mesh, a batch split over the data
    axes is cut rank by rank (microbatch i holds slice i of every rank's
    rows), each gradient takes its parameter's layout, and the metrics
    are plain tensors."""
    in_mesh = _in_mesh(mesh, rules)

    def slice_mb(i, t):
        if isinstance(t, DTensor) and any(isinstance(p, Shard) and p.dim == 0 for p in t.placements):
            local = t.to_local()
            mb = local.shape[0] // microbatches
            return DTensor.from_local(local[i * mb:(i + 1) * mb], t.device_mesh, t.placements,
                                      run_check=False)
        mb = t.shape[0] // microbatches
        return t[i * mb:(i + 1) * mb]

    def train_step(params, opt_state, batch):
        with in_mesh():
            return step_in_context(params, opt_state, batch)

    def step_in_context(params, opt_state, batch):
        if microbatches > 1:
            gsum, losses = None, []
            for i in range(microbatches):
                loss_i, g = value_and_grad(cfg, params, {k: slice_mb(i, t) for k, t in batch.items()})
                gsum = ({n: x.float() for n, x in g.items()} if gsum is None
                        else {n: gsum[n] + g[n].float() for n in gsum})
                losses.append(loss_i)
            grads = {n: x / microbatches for n, x in gsum.items()}
            loss = torch.mean(torch.stack(losses))
        else:
            loss, grads = value_and_grad(cfg, params, batch)
        leaves = {n: p.detach() for n, p in params.named_parameters()}
        if mesh is not None:
            grads = {n: g.redistribute(leaves[n].device_mesh, leaves[n].placements) for n, g in grads.items()}
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        new_params, new_opt = adamw_update(grads, opt_state, leaves, lr)
        with torch.no_grad():
            for n, p in leaves.items():
                p.copy_(new_params[n])
        return params, new_opt, {"loss": _full(loss), "grad_norm": _full(gnorm)}

    return train_step


def make_prefill_step(cfg: ModelConfig, total_len: int, *, mesh=None, rules: ShardingRules | None = None):
    in_mesh = _in_mesh(mesh, rules)

    def prefill_step(params, batch):
        with in_mesh():
            return M.prefill(cfg, params, batch, total_len)

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, mesh=None, rules: ShardingRules | None = None):
    in_mesh = _in_mesh(mesh, rules)

    def serve_step(params, caches, token, pos):
        with in_mesh():
            return M.decode_step(cfg, params, caches, token, pos)

    return serve_step


def serve_config(cfg: ModelConfig) -> ModelConfig:
    """Serving stores parameters in bf16 (no fp32 master needed)."""
    return dataclasses.replace(cfg, param_dtype="bfloat16", remat=False)
