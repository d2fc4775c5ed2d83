"""PyTorch/CUDA port of the congestion-aware partition placement and routing
solver (the JAX package `repro` is the reference it is held against).

Layout mirrors `repro`: `core/` holds the problem structures, the paper's
flow/marginal/forwarding/placement steps, the round engine and the four
methods; `kernels/` holds the two kernel families of the main path
(Neumann propagation and min-plus products), each a hand-written CUDA
kernel under `csrc/` beside its plain PyTorch version; `fleet/pad.py`
stacks same-shape instances for the batched engine.

Device rule: every public constructor and solver takes `device=` and
defaults to "cuda". Without a GPU they raise unless the caller passes
`device="cpu"`, which runs the plain PyTorch versions of the kernels.
Solvers run on the device their `Problem`'s tensors live on.
"""
from .device import resolve_device  # noqa: F401
