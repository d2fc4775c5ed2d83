"""Device resolution for the port's entry points.

There is no fallback: "cuda" (the default of every public entry point)
raises when no GPU is present, and only an explicit "cpu" runs on the CPU.
On the card, TF32 is switched off for matrix products and cuDNN before any
solve: a TF32 product keeps about three decimal digits, which would break
the 1e-6 Neumann contract of the plain paths (`lu`, the reference solves).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return `device` as a torch.device, ready for a solve.

    Raises RuntimeError for a CUDA device on a machine without one, and
    ValueError for any device type other than "cuda" or "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: device='cuda' requested but torch.cuda.is_available() "
                "is False; pass device='cpu' explicitly to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            raise RuntimeError("repro_torch: could not switch TF32 off")
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev


def solve_device(data_device: torch.device, device: str | torch.device = "cuda") -> torch.device:
    """The device a solve (or a model run) runs on: `device` (resolved as
    above), which must be where the problem's (or the model's) tensors
    live. No tensor is moved behind the caller's back: a mismatch raises
    ValueError."""
    dev = resolve_device(device)
    if dev.type != data_device.type or (dev.index is not None and dev.index != data_device.index):
        raise ValueError(
            f"repro_torch: the data lives on {data_device} but the call asked for "
            f"device={str(dev)!r}; build the problem or model on the device you run on"
        )
    return data_device
