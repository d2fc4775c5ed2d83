"""Faults planted in the program's round engine, where its answer is
made, for the readings that set the limits (`control.py --plant`) and for
the tests that see `correct` come out false. Each replaces
`repro_torch.fleet.solve.engine_solve` for the duration of a `with`."""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "altered")


def broken_engine(fault: str, real):
    """`real` (the engine) with `fault` planted:

    unchanged   every step returns its state unchanged (no round runs)
    half_batch  the second half of the lanes come back unsolved
    altered     lane 0's J is altered by 0.1% where it is produced
    """
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; expected one of {FAULTS}")

    def engine(stacked, **kw):
        if fault == "unchanged":
            return real(stacked, **dict(kw, m_max=0))
        out = real(stacked, **kw)
        if fault == "half_batch":
            init = real(stacked, **dict(kw, m_max=0))
            half = out["J"].shape[0] // 2
            for key in ("J", "J_comm", "J_comp", "hosts"):
                out[key] = torch.cat([out[key][:half], init[key][half:]])
            out["state"] = type(out["state"])(
                x=torch.cat([out["state"].x[:half], init["state"].x[half:]]),
                phi=torch.cat([out["state"].phi[:half], init["state"].phi[half:]]))
        else:
            out["J"] = out["J"].clone()
            out["J"][0] *= 1.001
        return out

    return engine


@contextlib.contextmanager
def planted(fault: str | None):
    """Run the body with `fault` planted (None plants nothing)."""
    if fault is None:
        yield
        return
    from repro_torch.fleet import solve

    real = solve.engine_solve
    solve.engine_solve = broken_engine(fault, real)
    try:
        yield
    finally:
        solve.engine_solve = real
