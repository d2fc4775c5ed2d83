"""Host-side observability of the serve path: span tracing (`trace`) and a
process-local metrics registry (`metrics`), copies of the JAX package's
modules of the same names. The round traces and phase profiler of the
solver (`obs/roundtrace.py`, `obs/phases.py`) are not ported yet."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, registry  # noqa: F401
from .trace import (  # noqa: F401
    TRACER,
    SpanEvent,
    Tracer,
    chrome_path_for,
    configure,
    flush,
    maybe_configure_from_env,
    span,
    tracer_enabled,
)
