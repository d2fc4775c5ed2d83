"""Host waits on the device, counted where they happen.

Every point on the fleet re-plan path where the host waits for the device
(a device-to-host read, or a blocking copy the host must wait for) adds to
one process-wide counter, `device.host_syncs` in `obs.metrics.registry`,
whether or not tracing is on:

  read_flag(t, site)   `bool(t)` of a one-element device tensor: one sync,
                       and while tracing a `device.sync` span whose `site`
                       attribute names the caller (`engine.exit_flag`,
                       `minplus.closure`)
  count_syncs(n)       n blocking copies made by one call (a loop over
                       instances or fields counts once, in bulk)
  sync_span(name, ...) a span whose `host_syncs` attribute, set as it
                       closes, counts the syncs made inside it

Counts are host-side tallies: nothing here touches the device beyond the
read it wraps. A site counts the reads the card path makes, on every
device, so a CPU run counts what a run on the card would.
"""
from __future__ import annotations

import contextlib

from .metrics import registry
from .trace import TRACER, span

HOST_SYNCS = "device.host_syncs"


def host_syncs() -> int:
    """Host syncs counted so far in this process."""
    return registry.counter(HOST_SYNCS).value


def count_syncs(n: int) -> None:
    """Count `n` host syncs made by one call."""
    registry.counter(HOST_SYNCS).inc(n)


def read_flag(t, site: str) -> bool:
    """`bool(t)`, counted as one host sync (a `device.sync` span while
    tracing)."""
    registry.counter(HOST_SYNCS).inc()
    if not TRACER.enabled:
        return bool(t)
    with span("device.sync", site=site):
        return bool(t)


@contextlib.contextmanager
def sync_span(name: str, **attrs):
    """`span(name, **attrs)` that records `host_syncs`, the syncs counted
    while it was open, at its close; nothing while tracing is off."""
    with span(name, **attrs) as rec:
        if rec is None:
            yield
            return
        first = host_syncs()
        try:
            yield
        finally:
            rec["host_syncs"] = host_syncs() - first
