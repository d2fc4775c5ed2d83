"""Minimal AdamW (+ global-norm clipping, cosine schedule): the JAX
package's `optim/adamw.py` as plain functions on dicts of tensors keyed by
parameter name (`ParamTree.named_parameters()` names).

The arithmetic is the reference's, op for op: fp32 moments, the bias
corrections `1 - b**step` computed in fp32 from the int32 step, the update
`mhat / (sqrt(vhat) + eps) + wd * p`, and clipping by
`min(1, max_norm / (gn + 1e-9))`. `torch.optim.AdamW` and
`clip_grad_norm_` round elsewhere and put eps and the clip floor in other
places, so they are not used. Every function returns new tensors, as the
reference's do; the train step copies the new parameters into the model.
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import torch
from torch import nn


def _leaves(params) -> dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> dict:
    """{"mu", "nu": fp32 zeros keyed like `params`, "step": int32 0}, on the
    parameters' device; a DTensor parameter's moments take its layout.
    `params`: {name: tensor} or a module."""
    leaves = _leaves(params)
    dev = next(iter(leaves.values())).device
    mu = {n: torch.zeros_like(p, dtype=torch.float32, requires_grad=False) for n, p in leaves.items()}
    nu = {n: torch.zeros_like(p, dtype=torch.float32, requires_grad=False) for n, p in leaves.items()}
    return {"mu": mu, "nu": nu, "step": torch.zeros((), dtype=torch.int32, device=dev)}


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """(grads scaled by min(1, max_norm / (gn + 1e-9)), gn): gn is the fp32
    L2 norm over every leaf, summed leaf by leaf. DTensor gradients sum
    over the whole mesh: a leaf's sum over its shards is reduced across
    them before it joins the total."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, gn


def adamw_update(
    grads: Mapping[str, torch.Tensor],
    state: dict,
    params: Mapping[str, torch.Tensor],
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    """One AdamW step: (new params, new state), keyed as `params`."""
    step = state["step"] + 1
    sf = step.float()
    bc1 = 1.0 - b1 ** sf
    bc2 = 1.0 - b2 ** sf
    new_p, new_mu, new_nu = {}, {}, {}
    for n, p in params.items():
        gf = grads[n].float()
        mu_n = b1 * state["mu"][n] + (1 - b1) * gf
        nu_n = b2 * state["nu"][n] + (1 - b2) * torch.square(gf)
        mhat = mu_n / bc1
        vhat = nu_n / bc2
        pf = p.detach().float()
        new_p[n] = (pf - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf)).to(p.dtype)
        new_mu[n], new_nu[n] = mu_n, nu_n
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}


def cosine_schedule(step: torch.Tensor, *, peak_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to `peak_lr`, then a cosine decay to `min_frac` of it."""
    sf = step.float()
    warm = peak_lr * sf / max(warmup, 1)
    prog = torch.clamp((sf - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
