"""Fault injection for the control plane: seeded chaos over fleet problems
(the JAX package's `repro.chaos`, on PyTorch).

events.py  — fault-trace generation (node churn, link degradation, flash
             crowds) and application to `Problem`s via the pad encoding
repair.py  — fleet-level placement repair after faults (one batched
             eviction) and the zero-load APSP cache behind it

launch/control.py is the epoch controller that drives trace -> repair ->
warm re-solve.
"""
from .events import (  # noqa: F401
    EVENT_KINDS,
    FLASH_CROWD,
    FLASH_END,
    LINK_DEGRADE,
    LINK_RESTORE,
    NODE_DOWN,
    NODE_UP,
    FaultEvent,
    FaultTrace,
    InstanceHealth,
    apply_health,
    generate_trace,
)
from .repair import Apsp0Cache, refresh_apsp0, repair_fleet  # noqa: F401
