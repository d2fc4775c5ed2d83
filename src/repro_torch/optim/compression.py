"""int8 gradient compression with error feedback (the JAX package's
`optim/compression.py`): per-tensor symmetric quantization for a gradient
exchange between hosts, with the quantization error carried to the next
step. No CLI flag uses it, in the reference either.

`torch.round` and `jnp.round` both round half to even, so `q`, the scale
and the error are bitwise the reference's.
"""
from __future__ import annotations

import torch


def compress_int8(x: torch.Tensor, error: torch.Tensor | None = None):
    """Per-tensor symmetric int8 quantization. Returns (q, scale, new_error)."""
    xf = x.float()
    if error is not None:
        xf = xf + error
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    recon = q.float() * scale
    new_error = xf - recon
    return q, scale, new_error


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
