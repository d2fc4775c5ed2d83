"""Host-side observability: span tracing (`trace`), a process-local
metrics registry (`metrics`), the fleet's round trace (`roundtrace`) and
the span-trace validator (`validate`, `python -m repro_torch.obs.validate
spans.jsonl`), ports of the JAX package's modules of the same names, and
the count of the host's waits on the device (`sync`)."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, registry  # noqa: F401
from .roundtrace import FleetTrace  # noqa: F401
from .sync import count_syncs, host_syncs, read_flag, sync_span  # noqa: F401
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
