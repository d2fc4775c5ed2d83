"""Host-side observability: span tracing (`trace`), a process-local
metrics registry (`metrics`), the fleet's round trace (`roundtrace`), the
span-trace validator (`validate`, `python -m repro_torch.obs.validate
spans.jsonl`) and the round-phase profiler (`phases`, timed with CUDA
events on the card), ports of the JAX package's modules of the same
names."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, registry  # noqa: F401
from .phases import profile_round_phases  # noqa: F401
from .roundtrace import FleetTrace  # noqa: F401
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
