"""JAX pytree <-> numpy-dict bridge for the port's parity tests.

A JAX `Problem` / `State` flattens to a dict keyed by its dataclass field
paths (`net.adj`, `apps.L`, `cost.rho_max`, `x`, `phi`, ...) through
`np.asarray`; `repro_torch`'s `Problem.from_numpy` / `State.from_numpy`
take the same dict and `to_numpy()` gives it back. Only the tests import
both packages; data crosses between them as numpy arrays.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from repro.core import structs as jstructs
from repro_torch.core import structs as tstructs


def _flatten(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            out.update(_flatten(v, key + "."))
        elif f.name not in ("kind", "hop_bound"):
            out[key] = np.asarray(v)
    return out


def problem_arrays(problem) -> dict:
    """Flatten a JAX Problem to {field path: np.ndarray}."""
    return _flatten(problem)


def state_arrays(state) -> dict:
    """Flatten a JAX State to {"x": ..., "phi": ...}."""
    return _flatten(state)


def to_torch_problem(problem, device="cpu"):
    """The JAX Problem as a repro_torch Problem (unbatched) on `device`."""
    return tstructs.Problem.from_numpy(
        problem_arrays(problem), hop_bound=problem.hop_bound,
        kind=problem.cost.kind, device=device,
    )


def to_torch_state(state, device="cpu"):
    return tstructs.State.from_numpy(state_arrays(state), device=device)


def to_jax_state(state):
    """A repro_torch State (unbatched or squeezed) as a JAX State."""
    arrs = state.to_numpy()
    return jstructs.State(x=jnp.asarray(arrs["x"]), phi=jnp.asarray(arrs["phi"]))
