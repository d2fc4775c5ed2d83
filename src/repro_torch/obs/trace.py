"""Span-based host tracing (a copy of the JAX package's `obs/trace.py`,
with PyTorch's profiler in place of JAX's).

`with span("serve.prefill", admitted=8):` wraps one host-side phase; the
tracer records (name, ts, dur, attrs, parent) events that serialize to

  * JSONL — one event per line with schema ``{ts, name, dur, attrs}`` plus
    the structural fields ``{id, parent, tid, depth}``, and
  * Chrome ``trace_event`` JSON (``"ph": "X"`` complete events, microsecond
    timestamps on the Unix-epoch clock torch.profiler's events use, so a
    span file and a profiler trace of the same run share one timeline)
    loadable in Perfetto or chrome://tracing.

Tracing is off by default and costs a single attribute read per span when
disabled. Enable programmatically (`configure(enabled=True, jsonl_path=...)`)
or by environment:

  REPRO_TRACE=/path/out.jsonl   enable and write the JSONL there (plus a
                                sibling Chrome file, `.jsonl` replaced by
                                `.trace.json`) at process exit

While enabled, every span is also a `torch.profiler.record_function`
range, so host spans line up with device kernels inside a
`torch.profiler` capture (the JAX package did this with
`jax.profiler.TraceAnnotation` behind a second variable; here the range
costs about a microsecond and needs no switch of its own).

`with span(...) as attrs:` hands the body the span's attribute dict (None
while tracing is off), so a body can record what it only knows at its end,
such as the host syncs it made (`obs/sync.py`).

Spans nest through a thread-local stack, so concurrent threads trace
independently. Events are recorded at span *exit* (a parent's duration is
unknown while its children run), which means children precede their parent
in the stream — consumers join on the explicit `parent` id rather than
stream order.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import os
import pathlib
import threading
import time

import torch

TRACE_ENV = "REPRO_TRACE"


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One closed span. `ts`/`dur` are seconds relative to the tracer epoch.

    id     : unique per tracer, assigned at span entry
    parent : id of the enclosing span on the same thread, -1 for a root
    depth  : nesting depth (0 = root); always parent.depth + 1
    tid    : OS thread ident the span ran on
    """

    id: int
    parent: int
    name: str
    ts: float
    dur: float
    tid: int
    depth: int
    attrs: dict

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def to_chrome(self, epoch_us: float) -> dict:
        """Chrome trace_event "complete" event (microsecond clock, offset by
        the tracer epoch `epoch_us`)."""
        return {
            "name": self.name,
            "cat": "repro",
            "ph": "X",
            "ts": epoch_us + self.ts * 1e6,
            "dur": self.dur * 1e6,
            "pid": os.getpid(),
            "tid": self.tid,
            "args": self.attrs,
        }


class Tracer:
    """Collects `SpanEvent`s; one process-wide instance lives in `TRACER`.

    Instantiable separately for tests — a fresh Tracer shares nothing with
    the global one."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self._events: list[SpanEvent] = []
        self._epoch = time.perf_counter()
        # The same instant in Unix-epoch nanoseconds: torch.profiler's clock.
        self._epoch_unix_ns = time.time_ns()
        self._next_id = 0
        self.enabled = False
        self.jsonl_path: str | None = None
        self.chrome_path: str | None = None

    # -- recording ----------------------------------------------------------
    def _stack(self) -> list[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Trace one host-side phase; a no-op unless the tracer is enabled.

        Keyword attributes must be JSON-serializable (they land in the
        JSONL `attrs` object and the Chrome `args` object verbatim). The
        body receives the attribute dict, and keys it adds before the span
        closes are recorded with it; while disabled it receives None."""
        if not self.enabled:
            yield None
            return
        stack = self._stack()
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        parent = stack[-1] if stack else -1
        depth = len(stack)
        stack.append(sid)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield attrs
        finally:
            t1 = time.perf_counter()
            stack.pop()
            event = SpanEvent(
                id=sid,
                parent=parent,
                name=name,
                ts=t0 - self._epoch,
                dur=t1 - t0,
                tid=threading.get_ident(),
                depth=depth,
                attrs=attrs,
            )
            with self._lock:
                self._events.append(event)

    # -- inspection / lifecycle ---------------------------------------------
    def events(self) -> list[SpanEvent]:
        with self._lock:
            return list(self._events)

    def reset(self) -> None:
        """Drop recorded events (the epoch is kept so ts stays monotone)."""
        with self._lock:
            self._events.clear()

    def configure(
        self,
        enabled: bool = True,
        jsonl_path: str | None = None,
        chrome_path: str | None = None,
    ) -> None:
        self.enabled = enabled
        if jsonl_path is not None:
            self.jsonl_path = str(jsonl_path)
        if chrome_path is not None:
            self.chrome_path = str(chrome_path)

    # -- serialization ------------------------------------------------------
    def write_jsonl(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as fh:
            for ev in self.events():
                fh.write(json.dumps(ev.to_json()) + "\n")

    def write_chrome_trace(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "traceEvents": [ev.to_chrome(self._epoch_unix_ns / 1e3) for ev in self.events()],
            "displayTimeUnit": "ms",
        }
        path.write_text(json.dumps(payload))

    def flush(self) -> None:
        """Write whatever output paths were configured (no-op otherwise)."""
        if self.jsonl_path:
            self.write_jsonl(self.jsonl_path)
        if self.chrome_path:
            self.write_chrome_trace(self.chrome_path)


# ---------------------------------------------------------------------------
# Process-wide tracer + convenience module API
# ---------------------------------------------------------------------------
TRACER = Tracer()


def span(name: str, **attrs):
    """`with span("solve_fleet.chunk", chunk=i):` on the global tracer."""
    return TRACER.span(name, **attrs)


def configure(
    enabled: bool = True,
    jsonl_path: str | None = None,
    chrome_path: str | None = None,
    flush_at_exit: bool = False,
) -> None:
    TRACER.configure(
        enabled=enabled, jsonl_path=jsonl_path, chrome_path=chrome_path
    )
    if flush_at_exit:
        _register_atexit_flush()


def tracer_enabled() -> bool:
    return TRACER.enabled


def flush() -> None:
    TRACER.flush()


def reset() -> None:
    TRACER.reset()


_ATEXIT_REGISTERED = False


def _register_atexit_flush() -> None:
    global _ATEXIT_REGISTERED
    if not _ATEXIT_REGISTERED:
        atexit.register(TRACER.flush)
        _ATEXIT_REGISTERED = True


def chrome_path_for(jsonl_path) -> str:
    """Sibling Chrome-trace path for a JSONL path (`x.jsonl` -> `x.trace.json`)."""
    p = pathlib.Path(jsonl_path)
    stem = p.name[: -len(".jsonl")] if p.name.endswith(".jsonl") else p.name
    return str(p.with_name(stem + ".trace.json"))


def maybe_configure_from_env() -> bool:
    """Enable the global tracer when REPRO_TRACE names an output path.

    Entry points (launch CLIs, the benchmark harness) call this once at
    startup; the trace is flushed at process exit. Returns whether tracing
    is enabled afterwards (already-configured tracers are left alone)."""
    if TRACER.enabled:
        return True
    path = os.environ.get(TRACE_ENV)
    if not path:
        return False
    configure(
        enabled=True,
        jsonl_path=path,
        chrome_path=chrome_path_for(path),
        flush_at_exit=True,
    )
    return True
